"""Host-side helpers with a compiled copy (port of ``tpufluid.native``)."""
