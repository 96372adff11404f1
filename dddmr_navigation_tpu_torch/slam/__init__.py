"""SLAM: lidar odometry and mapping (reference ``dddmr_lego_loam``), the
counterpart of ``dddmr_navigation_tpu/slam``."""
from dddmr_navigation_tpu_torch.slam.projection import (
    RangeImage, project, project_scan, mark_ground, segment_image)
from dddmr_navigation_tpu_torch.slam.features import (
    FeatureSet, extract_features, smoothness, occlusion_mask)
from dddmr_navigation_tpu_torch.slam.scan_matching import (
    match_scans, match_to_map, icp_point2point)
from dddmr_navigation_tpu_torch.slam.pose_graph import (
    PoseGraphArrays, empty_graph, add_node, add_edge,
    optimize_pose_graph, detect_loop_candidate)
from dddmr_navigation_tpu_torch.slam.pipeline import MappingSession
from dddmr_navigation_tpu_torch.slam.editor import GraphEditor
