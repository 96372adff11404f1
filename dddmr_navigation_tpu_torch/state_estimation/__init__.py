"""MCL for a fleet (counterpart of ``dddmr_navigation_tpu/state_estimation``
for the particle filter, the lidar likelihood and the update tick)."""
