"""Scorers of the three benchmark formats, on the host (numpy, scipy, cv2):

* :mod:`stemseg_tpu_torch.eval.davis`: unsupervised DAVIS J&F (region IoU,
  boundary F-measure, Hungarian proposal-to-object matching);
* :mod:`stemseg_tpu_torch.eval.mots`: CLEAR-MOTS for KITTI-MOTS (sMOTSA,
  MOTSA, MOTSP, id switches, ignore regions);
* :mod:`stemseg_tpu_torch.eval.ytvis`: YouTube-VIS AP (spatio-temporal mask
  IoU, COCO-style 101-point AP over IoU 0.5:0.05:0.95) and AR.

``python -m stemseg_tpu_torch.eval.main`` scores an inference CLI's output
against the ground-truth JSONs.
"""

from stemseg_tpu_torch.eval.davis import db_eval_boundary, db_eval_iou, evaluate_davis_sequence
from stemseg_tpu_torch.eval.mots import evaluate_mots
from stemseg_tpu_torch.eval.ytvis import evaluate_ytvis

__all__ = [
    "db_eval_iou",
    "db_eval_boundary",
    "evaluate_davis_sequence",
    "evaluate_mots",
    "evaluate_ytvis",
]
