"""The plain versions of the port's two kernels."""
from navbench.reference.ops.collision import swept_box_hits
from navbench.reference.ops.distance_field import masked_min_distance
