from stemseg_tpu_torch.data.augmenter import ImageToSeqAugmenter  # noqa: F401
from stemseg_tpu_torch.data.collate import collate_fn  # noqa: F401
from stemseg_tpu_torch.data.concat_dataset import ConcatDataset, SparseDataset  # noqa: F401
from stemseg_tpu_torch.data.image_clip_loaders import (  # noqa: F401
    CocoDataLoader,
    MapillaryDataLoader,
    PascalVOCDataLoader,
)
from stemseg_tpu_torch.data.instance_duplicator import InstanceDuplicator  # noqa: F401
from stemseg_tpu_torch.data.parsers import (  # noqa: F401
    GenericImageSample,
    GenericVideoSequence,
    parse_generic_image_dataset,
    parse_generic_video_dataset,
)
from stemseg_tpu_torch.data.samplers import (  # noqa: F401
    BatchSampler,
    IterationBasedBatchSampler,
    ShardedSampler,
    sample_generators,
    sample_seed,
)
from stemseg_tpu_torch.data.video_dataset import VideoDataset  # noqa: F401
from stemseg_tpu_torch.data.video_loaders import (  # noqa: F401
    DavisDataLoader,
    MOTSDataLoader,
    YoutubeVISDataLoader,
)
