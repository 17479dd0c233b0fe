from stemseg_tpu_torch.ops.cluster import (  # noqa: F401
    cluster_points,
    cluster_points_reference,
    cluster_points_single,
    cluster_points_tiled,
    launch_counts,
    reset_launch_counts,
)
