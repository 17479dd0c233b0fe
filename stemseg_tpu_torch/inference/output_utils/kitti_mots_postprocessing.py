"""Offline "NMS" of KITTI-MOTS results: drop small or box-sparse detections,
then fragmented and short tracks, with thresholds per class.

The filters run in this order: detection area >= ``min_*_area``; pixel
over bounding-box area > ``min_area_ratio_*``; a track's share of time
breaks (gaps between consecutive detections) <= ``max_time_break_ratio_*``;
track length >= ``min_track_length_*``. ``postprocess_results(DIR)`` writes
the kept lines of every ``DIR/????.txt`` to ``DIR_nms/``. Also a CLI:
``python -m stemseg_tpu_torch.inference.output_utils.kitti_mots_postprocessing
DIR [--min_car_area N ...]``.
"""

from __future__ import annotations

import os
from collections import defaultdict
from glob import glob
from typing import Dict, List

from stemseg_tpu_torch.utils import rle as rle_codec

CAR_CLASS_ID = 1
PERSON_CLASS_ID = 2

DEFAULTS = dict(
    min_car_area=150,
    min_person_area=250,
    min_track_length_car=3,
    min_track_length_person=10,
    min_area_ratio_car=0.35,
    min_area_ratio_person=0.2,
    max_time_break_ratio_car=0.3,
    max_time_break_ratio_person=0.5,
)


class Detection:
    def __init__(self, frame_id: int, track_id: int, class_id: int, mask: dict):
        self.frame_id = frame_id
        self.track_id = track_id
        self.class_id = class_id
        self.mask = mask

    @classmethod
    def from_txt(cls, line: str) -> "Detection":
        fields = line.strip().split(" ")
        return cls(int(fields[0]), int(fields[1]), int(fields[2]),
                   {"size": (int(fields[3]), int(fields[4])),
                    "counts": fields[5].encode("utf-8")})

    def as_txt(self) -> str:
        return (f"{self.frame_id} {self.track_id} {self.class_id} {self.mask['size'][0]} "
                f"{self.mask['size'][1]} {self.mask['counts'].decode('utf-8')}")

    @property
    def pixel_area(self) -> int:
        return rle_codec.area(self.mask)

    @property
    def pixel_bbox_area_ratio(self) -> float:
        _, _, w, h = rle_codec.toBbox(self.mask)
        box_area = w * h
        return float(self.pixel_area) / float(box_area) if box_area else 0.0


def _to_tracks(detections: List[Detection]) -> List[List[Detection]]:
    tracks: Dict[int, List[Detection]] = defaultdict(list)
    for det in detections:
        tracks[det.track_id].append(det)
    return [sorted(t, key=lambda d: d.frame_id) for t in tracks.values()]


def _n_time_breaks(track: List[Detection]) -> int:
    return sum(int(b.frame_id - a.frame_id > 1) for a, b in zip(track, track[1:]))


def _threshold(class_id: int, car_value, person_value):
    return car_value if class_id == CAR_CLASS_ID else person_value


def postprocess_detections(detections: List[Detection], **kw) -> List[Detection]:
    p = {**DEFAULTS, **kw}
    detections = [d for d in detections if d.pixel_area >= _threshold(
        d.class_id, p["min_car_area"], p["min_person_area"])]
    detections = [d for d in detections if d.pixel_bbox_area_ratio > _threshold(
        d.class_id, p["min_area_ratio_car"], p["min_area_ratio_person"])]
    detections = [d for track in _to_tracks(detections)
                  if float(_n_time_breaks(track)) / float(len(track)) <= _threshold(
                      track[0].class_id, p["max_time_break_ratio_car"],
                      p["max_time_break_ratio_person"])
                  for d in track]
    return [d for track in _to_tracks(detections)
            if len(track) >= _threshold(track[0].class_id, p["min_track_length_car"],
                                        p["min_track_length_person"])
            for d in track]


def postprocess_results(results_dir: str, output_dir_suffix: str = "nms", **kw) -> str:
    """Filter every ``results_dir/????.txt`` into ``results_dir_<suffix>/``;
    returns that directory."""
    output_dir = f"{results_dir}_{output_dir_suffix}"
    os.makedirs(output_dir, exist_ok=True)
    for path in sorted(glob(os.path.join(results_dir, "????.txt"))):
        name = os.path.basename(path)
        print(f"Processing {name}")
        with open(path) as fh:
            detections = [Detection.from_txt(line) for line in fh]
        with open(os.path.join(output_dir, name), "w") as fh:
            fh.writelines(d.as_txt() + "\n" for d in postprocess_detections(detections, **kw))
    print(f"Results after applying NMS written to: {output_dir}")
    return output_dir


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(description="KITTI-MOTS result filtering")
    parser.add_argument("results_dir")
    for key, val in DEFAULTS.items():
        parser.add_argument(f"--{key}", type=type(val), default=val)
    args = vars(parser.parse_args(argv))
    postprocess_results(args.pop("results_dir"), **args)


if __name__ == "__main__":
    main()
