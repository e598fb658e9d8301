from .scenes import (  # noqa: F401
    Scene,
    batch_scenes,
    dam_break_4k,
    default_scene,
    scene_64k,
    scene_256k,
    scene_1m,
    scene_4m,
)
