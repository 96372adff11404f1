"""The fused perception → global replan → local tick (counterpart of
``dddmr_navigation_tpu/control``)."""
