"""Host runtime: the port's copy of part of
``dddmr_navigation_tpu/runtime``."""
