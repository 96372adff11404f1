"""State estimation (counterpart of ``dddmr_navigation_tpu/state_estimation``):
MCL for a fleet (the particle filter, the lidar likelihood and the update
tick), pose-graph submaps, feature-weight preprocessing, 3D odometry and
global localization."""
