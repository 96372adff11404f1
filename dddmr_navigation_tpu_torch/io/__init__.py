"""Map builders, PCD files, occupancy grids, rosbag2 reading and the native
host runtime (counterpart of ``dddmr_navigation_tpu/io``)."""
from dddmr_navigation_tpu_torch.io.pcd import read_pcd, write_pcd
from dddmr_navigation_tpu_torch.io.maps import (
    box_obstacle,
    flat_ground_map,
    ramp_ground_map,
    corridor_map,
    multi_level_map,
    voxel_downsample,
)
from dddmr_navigation_tpu_torch.io.occupancy import (
    read_pgm,
    occupancy_to_clouds,
    cloud_to_occupancy,
)
