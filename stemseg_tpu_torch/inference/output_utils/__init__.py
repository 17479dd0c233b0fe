from stemseg_tpu_torch.inference.output_utils.common import annotate_instance  # noqa: F401
from stemseg_tpu_torch.inference.output_utils.davis import DavisOutputGenerator  # noqa: F401
from stemseg_tpu_torch.inference.output_utils.kitti_mots import (  # noqa: F401
    KittiMOTSOutputGenerator,
)
from stemseg_tpu_torch.inference.output_utils.youtube_vis import (  # noqa: F401
    YoutubeVISOutputGenerator,
)
