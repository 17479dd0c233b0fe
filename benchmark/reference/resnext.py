"""Plain float32 STEm-Seg model on a ResNeXt body (X-101-FPN): the
aggregated residual transformation of Xie et al., "Aggregated Residual
Transformations for Deep Neural Networks" (CVPR 2017, arXiv:1611.05431),
form (c): a 1x1 conv to ``groups x width`` channels, a grouped 3x3 conv,
a 1x1 conv out, each followed by frozen batch norm, and a projection
shortcut where the channels change. The widths are maskrcnn-benchmark's
``e2e_mask_rcnn_X_101_32x8d_FPN_1x.yaml`` (``NUM_GROUPS 32``,
``WIDTH_PER_GROUP 8``, ``STRIDE_IN_1X1 False``: the stride on the grouped
3x3), the code STEm-Seg's backbone is copied from.

``Model`` is ``model.py``'s ``Model`` (its ``ResNet`` already takes the
groups) with the stride of each stage's first bottleneck moved from its
first 1x1 conv to its grouped 3x3 when ``stride_in_1x1`` is False; the
modules and their names are ``model.py``'s. Departures from the paper and
the yaml, all shared with the system under test:

* frozen batch norm with eps 0, as the detection code freezes it (the
  paper trains with batch norm);
* ``stride_in_1x1`` True keeps the stride on the first 1x1 conv (the Mask
  R-CNN ResNet weights' convention): with one group this is ``model.py``'s
  model, which the tests hold;
* no FPN level above the body's last stage (``model.py``'s FPN), as
  STEm-Seg takes four maps.

Nothing here imports the system under test. TF32 stays off through
``common.set_numerics``, as for ``model.py``.
"""

from __future__ import annotations

from typing import Dict

from . import model as base

# X-101-FPN has R-101-FPN's stages (3, 4, 23, 3)
SAME_STAGES = {"X-101-FPN": "R-101-FPN"}


class Model(base.Model):
    """``cfg``: the configuration file's nested dict, as ``model.Model``
    takes it; the body by ``model.resnets`` (``num_groups``,
    ``width_per_group``, ``stride_in_1x1``)."""

    def __init__(self, cfg: Dict):
        m = cfg["model"]
        kind = m["backbone"]["type"]
        backbone = dict(m["backbone"], type=SAME_STAGES.get(kind, kind))
        super().__init__(dict(cfg, model=dict(m, backbone=backbone)))
        if not m["resnets"]["stride_in_1x1"]:
            body = self.backbone.body
            for i in range(1, body.n_stages + 1):
                first = getattr(body, f"layer{i}")[0]
                first.conv1.stride, first.conv2.stride = first.conv2.stride, first.conv1.stride
