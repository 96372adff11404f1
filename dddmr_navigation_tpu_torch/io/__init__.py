"""Map builders, PCD files and occupancy grids (the port's copies of part
of ``dddmr_navigation_tpu/io``)."""
from dddmr_navigation_tpu_torch.io.maps import (
    box_obstacle,
    flat_ground_map,
    multi_level_map,
    voxel_downsample,
)
from dddmr_navigation_tpu_torch.io.pcd import read_pcd, write_pcd
