"""Perception, batched over robots: the voxel window, FOV and range image,
the static map context, clustering, mark/clear and the distance field
(counterpart of ``dddmr_navigation_tpu/perception``)."""
