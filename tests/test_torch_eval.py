"""The port's scorers (``stemseg_tpu_torch.eval``) against the JAX
package's on the same inputs, with exact equality: both compute in float64
numpy on identical arrays, so every float must be the same float.

The cases are those of ``tests/test_eval.py`` (exact J values, F against
the official ``db_eval_boundary`` transcription at four sizes, the radius
rule, swapped proposals, recall and decay, sMOTSA with id switches, FPs
and ignore regions, YT-VIS ranking, area buckets, AR@maxDets, the tie
rule, no mutation of the inputs), seeded random masks, and each results
reader on files that the port's own writers wrote."""

import copy
import json

import numpy as np
import pytest

from stemseg_tpu.eval import davis as jax_davis
from stemseg_tpu.eval import mots as jax_mots
from stemseg_tpu.eval import ytvis as jax_ytvis
from stemseg_tpu_torch.eval import davis, mots, ytvis
from stemseg_tpu_torch.inference.output_utils import (
    DavisOutputGenerator,
    KittiMOTSOutputGenerator,
    YoutubeVISOutputGenerator,
)
from stemseg_tpu_torch.utils import rle
from test_eval import _adversarial_masks, _official_db_eval_boundary, _rect


def assert_same(ours, theirs):
    """Equal structure and exactly equal values (arrays, floats, ints)."""
    if isinstance(theirs, dict):
        assert list(ours) == list(theirs)
        for k in theirs:
            assert_same(ours[k], theirs[k])
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_same(a, b)
    elif isinstance(theirs, np.ndarray):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert np.array_equal(ours, theirs, equal_nan=True)
    else:
        assert type(ours) is type(theirs), (ours, theirs)
        assert ours == theirs or (ours != ours and theirs != theirs), (ours, theirs)  # NaN


def blobs(rng, t, h, w, n, p_empty=0.2):
    """``n`` random [t, h, w] uint8 volumes: drifting rectangles with
    holes, some frames empty."""
    out = []
    for _ in range(n):
        vol = np.zeros((t, h, w), np.uint8)
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        bh, bw = rng.randint(3, h // 2), rng.randint(3, w // 2)
        for i in range(t):
            if rng.rand() < p_empty:
                continue
            y = int(np.clip(y + rng.randint(-2, 3), 0, h - 2))
            x = int(np.clip(x + rng.randint(-2, 3), 0, w - 2))
            vol[i, y:y + bh, x:x + bw] = 1
            vol[i] &= (rng.rand(h, w) > 0.1).astype(np.uint8)
        out.append(vol)
    return out


# ---------------------------------------------------------------------------
# DAVIS J&F
# ---------------------------------------------------------------------------

def _iou_case(name):
    gt = np.stack([_rect(20, 20, 0, 10, 0, 10)])
    empty = np.zeros((1, 20, 20), np.uint8)
    if name == "exact":
        return gt, np.stack([_rect(20, 20, 0, 10, 5, 15)]), [50.0 / 150.0]
    if name == "both_empty":
        return empty, empty, [1.0]
    if name == "one_empty":
        return gt, empty, [0.0]
    a, b = blobs(np.random.RandomState(4), 6, 20, 30, 2)
    return a, b, None


@pytest.mark.parametrize("name", ["exact", "both_empty", "one_empty", "random"])
def test_db_eval_iou_equals_jax(name):
    gt, pred, want = _iou_case(name)
    got = davis.db_eval_iou(gt, pred)
    assert_same(got, jax_davis.db_eval_iou(gt, pred))
    if want is not None:
        assert got.tolist() == want


@pytest.mark.parametrize("h,w", [(16, 16), (17, 31), (24, 13), (64, 113)])
def test_db_eval_boundary_equals_jax_and_the_official_transcription(h, w):
    rng = np.random.RandomState(h * 100 + w)
    masks = _adversarial_masks(h, w, rng)
    pairs = [(a, b) for a in masks for b in masks[:6]] + list(zip(masks, masks))
    gt = np.stack([a for a, _ in pairs])
    pred = np.stack([b for _, b in pairs])
    got = davis.db_eval_boundary(gt, pred)
    assert_same(got, jax_davis.db_eval_boundary(gt, pred))
    want = [_official_db_eval_boundary(np.asarray(b, bool), np.asarray(a, bool))
            for a, b in pairs]
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("hw,radius", [((64, 113), 2), ((88, 88), 1), ((89, 89), 2)])
def test_boundary_radius_follows_the_official_ceil(hw, radius):
    h, w = hw
    a = np.zeros((1, h, w), np.uint8)
    b = np.zeros((1, h, w), np.uint8)
    a[0, 10:h - 10, 10:w - 20] = 1
    b[0, 10:h - 10, 12:w - 18] = 1  # a 2-pixel shift: F is 1 from radius 2 on
    got = davis.db_eval_boundary(a, b)
    assert_same(got, jax_davis.db_eval_boundary(a, b))
    assert (got[0] == 1.0) == (radius >= 2)


def test_boundary_map_and_disk_equal_jax():
    rng = np.random.RandomState(11)
    for m in _adversarial_masks(23, 37, rng):
        assert_same(davis._seg2bmap(m), jax_davis._seg2bmap(m))
    for r in range(12):
        assert_same(davis._disk(r), jax_davis._disk(r))


def _sequence_case(name):
    o1 = np.stack([_rect(32, 32, 2, 10, 2, 10)] * 3)
    o2 = np.stack([_rect(32, 32, 20, 30, 20, 30)] * 3)
    junk = np.stack([_rect(32, 32, 0, 2, 30, 32)] * 3)
    return {"swapped_with_junk": ([o1, o2], [o2, junk, o1], [1.0, 1.0]),
            "unmatched_object": ([o1, o2], [o1], [1.0, 0.0]),
            "no_proposals": ([o1, o2], [], [0.0, 0.0]),
            "no_objects": ([], [o1], []),
            "random": (blobs(np.random.RandomState(5), 5, 32, 40, 3),
                       blobs(np.random.RandomState(6), 5, 32, 40, 4), None)}[name]


@pytest.mark.parametrize("name", ["swapped_with_junk", "unmatched_object", "no_proposals",
                                  "no_objects", "random"])
def test_evaluate_davis_sequence_equals_jax(name):
    gt, pred, want_j = _sequence_case(name)
    for with_series in (False, True):
        got = davis.evaluate_davis_sequence(gt, pred, with_series=with_series)
        assert_same(got, jax_davis.evaluate_davis_sequence(gt, pred, with_series=with_series))
    if want_j is not None:
        assert got[0] == want_j


@pytest.mark.parametrize("series", [[1.0, 1.0, 0.4, 0.2], [0.7], [0.2, 0.9],
                                    [0.6, 0.1, 0.9], "random7", "random50"])
def test_recall_and_decay_equal_jax(series):
    if isinstance(series, str):
        series = np.random.RandomState(int(series[6:])).rand(int(series[6:]))
    series = np.asarray(series, np.float64)
    assert_same(davis._recall(series), jax_davis._recall(series))
    assert_same(davis._decay(series), jax_davis._decay(series))
    if len(series) == 4 and series[0] == 1.0:
        assert davis._recall(series) == 0.5 and davis._decay(series) == 1.0 - 0.3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_davis_on_random_sequences_equals_jax(seed):
    rng = np.random.RandomState(seed)
    gt, pred = {}, {}
    for s in range(3):
        t = rng.randint(3, 9)
        gt[f"s{s}"] = blobs(rng, t, 24, 36, rng.randint(1, 4))
        if s != 2 or seed != 1:  # a sequence without results
            pred[f"s{s}"] = blobs(rng, t, 24, 36, rng.randint(0, 5))
    got = davis.evaluate_davis(gt, pred)
    assert_same(got, jax_davis.evaluate_davis(gt, pred))
    assert 0.0 <= got["J&F"] <= 1.0


def test_evaluate_davis_recall_decay_and_global_mean():
    full = np.stack([_rect(16, 16, 0, 8, 0, 8)] * 4)
    half = full.copy()
    half[2:] = 0
    got = davis.evaluate_davis({"s": [full]}, {"s": [half]})
    assert_same(got, jax_davis.evaluate_davis({"s": [full]}, {"s": [half]}))
    assert (got["J_recall"], got["J_decay"], got["J_mean"]) == (0.5, 1.0, 0.5)


class _Seq:
    def __init__(self, seq_id, dims):
        self.id = seq_id
        self.image_dims = dims


def _labels(rng, t, h, w, k):
    """A [t, h, w] int32 label volume of ``k`` tracks (random rectangles,
    later ones on top) over outliers (-1), and its counts and lifetimes."""
    labels = np.full((t, h, w), -1, np.int32)
    for i in range(k):
        for f in range(t):
            if rng.rand() < 0.15:
                continue
            y, x = rng.randint(0, h - 3), rng.randint(0, w - 3)
            labels[f, y:y + rng.randint(2, h // 2), x:x + rng.randint(2, w // 2)] = i
    ids, counts = np.unique(labels, return_counts=True)
    lifetimes = {int(i): int(sum((labels[f] == i).any() for f in range(t))) for i in ids}
    return labels, {int(i): int(c) for i, c in zip(ids, counts)}, lifetimes


def test_davis_results_reader_on_the_port_writer_output(tmp_path):
    labels, counts, lifetimes = _labels(np.random.RandomState(2), 4, 16, 24, 5)
    writer = DavisOutputGenerator(str(tmp_path), device="cpu")
    kept = writer.process_sequence(_Seq("seqA", (64, 96)), labels, counts, lifetimes, None,
                                   mask_scale=4, max_tracks=4, min_dim=64, max_dim=96)
    seq_dir = str(tmp_path / "results" / "seqA")
    got = davis.load_davis_results_dir(seq_dir)
    assert_same(got, jax_davis.load_davis_results_dir(seq_dir))
    assert len(got) == len(kept) == 4 and got[0].shape == (4, 64, 96)


# ---------------------------------------------------------------------------
# KITTI-MOTS CLEAR-MOTS
# ---------------------------------------------------------------------------

def _mots_case(name):
    m = _rect(16, 16, 0, 8, 0, 8)
    other = _rect(16, 16, 10, 16, 10, 16)
    if name == "perfect":
        g = [{1: m}, {1: m}]
        return g, [{7: m}, {7: m}], None, {"TP": 2, "FP": 0, "IDS": 0, "sMOTSA": 1.0}
    if name == "id_switch_and_fp":
        return ([{1: m}, {1: m}], [{7: m}, {8: m, 9: other}], None,
                {"TP": 2, "IDS": 1, "FP": 1, "sMOTSA": 0.0, "MOTSA": 0.0})
    if name == "soft_iou_and_fn":
        g = [{1: _rect(16, 16, 0, 8, 0, 16), 2: _rect(16, 16, 12, 16, 0, 4)}]
        return (g, [{7: _rect(16, 16, 0, 8, 0, 12)}], None,
                {"TP": 1, "FN": 1, "soft_TP": 96.0 / 128.0, "sMOTSA": 96.0 / 128.0 / 2.0})
    if name == "ignore_region":
        return [{}], [{7: m}], [m], {"FP": 0}
    if name == "no_ignore_region":
        return [{}], [{7: m}], [None], {"FP": 1}
    rng = np.random.RandomState(9)
    gt, hyp, ignore = [], [], []
    for _ in range(6):
        gt.append({i: v[0] for i, v in enumerate(blobs(rng, 1, 20, 30, 3, 0.0))
                   if rng.rand() > 0.2})
        hyp.append({10 + i: v[0] for i, v in enumerate(blobs(rng, 1, 20, 30, 4, 0.0))})
        ignore.append(_rect(20, 30, 0, 10, 0, 12) if rng.rand() > 0.5 else None)
    return gt, hyp, ignore, {}


@pytest.mark.parametrize("name", ["perfect", "id_switch_and_fp", "soft_iou_and_fn",
                                  "ignore_region", "no_ignore_region", "random"])
def test_evaluate_mots_equals_jax(name):
    gt, hyp, ignore, want = _mots_case(name)
    got = mots.evaluate_mots(gt, hyp, ignore)
    assert_same(got, jax_mots.evaluate_mots(gt, hyp, ignore))
    for k, v in want.items():
        assert got[k] == v, k


def test_mask_iou_equals_jax():
    rng = np.random.RandomState(3)
    vols = blobs(rng, 8, 20, 30, 2)
    for a, b in zip(vols[0], vols[1]):
        assert_same(mots._mask_iou(a, b), jax_mots._mask_iou(a, b))


def test_mots_txt_reader_on_the_port_writer_output(tmp_path):
    rng = np.random.RandomState(4)
    labels, counts, lifetimes = _labels(rng, 4, 16, 24, 4)
    classes = rng.randint(0, 3, labels.shape).astype(np.int64)
    KittiMOTSOutputGenerator(str(tmp_path), device="cpu").process_sequence(
        _Seq("0002", (64, 96)), labels, counts, lifetimes, classes, mask_scale=4,
        max_tracks=4, min_dim=64, max_dim=96)
    path = str(tmp_path / "results" / "0002.txt")
    got = mots.parse_mots_txt(path)
    assert_same(got, jax_mots.parse_mots_txt(path))
    assert len(got[0]) == 4 and set(got[1].values()) <= {1, 2}


# ---------------------------------------------------------------------------
# YouTube-VIS AP
# ---------------------------------------------------------------------------

def test_st_mask_iou_equals_jax():
    a = [_rect(8, 8, 0, 4, 0, 8), _rect(8, 8, 0, 4, 0, 8), None, None]
    b = [_rect(8, 8, 0, 4, 0, 4), None, _rect(8, 8, 0, 2, 0, 2), None]
    got = ytvis.st_mask_iou(a, b)
    assert_same(got, jax_ytvis.st_mask_iou(a, b))
    assert got == 16.0 / 68.0
    assert_same(ytvis.st_mask_iou([None], [None]), jax_ytvis.st_mask_iou([None], [None]))


def _track(video, cat, masks, score=None):
    t = {"video": video, "category": cat, "masks": masks}
    if score is not None:
        t["score"] = score
    return t


def _ytvis_case(name):
    m = _rect(16, 16, 0, 8, 0, 8)
    if name == "perfect":
        return [_track("v", 1, [m, m])], [_track("v", 1, [m, m], 0.9)], {"AP": 1.0, "AP50": 1.0}
    if name == "iou_0_625":
        m6 = _rect(16, 16, 0, 8, 0, 5)
        return ([_track("v", 1, [m, m])], [_track("v", 1, [m6, m6], 0.9)],
                {"AP50": 1.0, "AP75": 0.0, "AP": 3.0 / 10.0})
    if name == "ranking":
        far = _rect(16, 16, 10, 16, 10, 16)
        return ([_track("v", 1, [m])],
                [_track("v", 1, [far], 0.9), _track("v", 1, [m], 0.5)], {"AP50": 0.5})
    if name == "category_averaging":
        return ([_track("v", 1, [m]), _track("v", 2, [m])], [_track("v", 1, [m], 0.9)],
                {"AP": 0.5})
    if name == "area_buckets":
        small = _rect(32, 32, 0, 16, 0, 16)
        medium = _rect(64, 64, 0, 40, 0, 40)
        large = _rect(128, 128, 0, 100, 0, 100)
        return ([_track("vs", 1, [small]), _track("vm", 1, [medium]), _track("vl", 1, [large])],
                [_track("vs", 1, [small], 0.9), _track("vm", 1, [medium], 0.8)],
                {"AP_S": 1.0, "AP_M": 1.0, "AP_L": 0.0, "AP": 67.0 / 101.0})
    if name == "ar_at_max_dets":
        m2 = _rect(16, 16, 8, 16, 8, 16)
        return ([_track("v", 1, [m]), _track("v", 1, [m2])],
                [_track("v", 1, [m], 0.9), _track("v", 1, [m2], 0.5)],
                {"AR10": 1.0, "AR1": 0.5, "AP": 1.0})
    if name == "tie_last_gt_wins":
        return ([_track("v", 1, [m]), _track("v", 1, [m])], [_track("v", 1, [m], 0.9)],
                {"AR10": 0.5})
    rng = np.random.RandomState(int(name[-1]))
    gt, preds = [], []
    for vid in ("a", "b", "c"):
        for k in range(rng.randint(1, 4)):
            vols = blobs(rng, 4, 24, 36, 1)[0]
            masks = [v if v.any() or rng.rand() > 0.5 else None for v in vols]
            gt.append(_track(vid, int(rng.randint(1, 4)), masks))
            if rng.rand() > 0.3:  # a noisy copy of it
                noisy = [None if v is None else (v ^ (rng.rand(24, 36) > 0.9)).astype(np.uint8)
                         for v in masks]
                preds.append(_track(vid, gt[-1]["category"], noisy, float(rng.rand())))
        for k in range(rng.randint(0, 3)):  # false positives, one score tied
            preds.append(_track(vid, int(rng.randint(1, 4)), list(blobs(rng, 4, 24, 36, 1)[0]),
                                0.5 if k == 0 else float(rng.rand())))
    return gt, preds, {}


YTVIS_CASES = ["perfect", "iou_0_625", "ranking", "category_averaging", "area_buckets",
               "ar_at_max_dets", "tie_last_gt_wins", "random0", "random1", "random2"]


@pytest.mark.parametrize("name", YTVIS_CASES)
def test_evaluate_ytvis_equals_jax(name):
    gt, preds, want = _ytvis_case(name)
    got = ytvis.evaluate_ytvis(gt, preds)
    assert_same(got, jax_ytvis.evaluate_ytvis(gt, preds))
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-15), k


def test_evaluate_ytvis_mutates_nothing_and_maxdets_is_a_prefix():
    gt, preds, _ = _ytvis_case("random1")
    before = copy.deepcopy((gt, preds))
    res = ytvis.evaluate_ytvis(gt, preds)
    assert_same((gt, preds), before)
    videos = sorted({p["video"] for p in preds})
    top1 = [max((p for p in preds if p["video"] == v), key=lambda p: p["score"])
            for v in videos]
    assert res["AR1"] == ytvis.evaluate_ytvis(gt, top1)["AR10"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_match_video_and_pr_curves_equal_jax(seed):
    rng = np.random.RandomState(seed)
    n_dt, n_gt = rng.randint(0, 7), rng.randint(0, 6)
    iou = np.round(rng.rand(n_dt, n_gt) * 4) / 4  # ties on purpose
    g_ig = rng.rand(n_gt) > 0.7
    order = np.argsort(g_ig, kind="stable")
    areas = rng.rand(n_dt) * 3000
    for rng_name, area_range in ytvis.AREA_RANGES.items():
        for thr in ytvis.IOU_THRESHOLDS:
            args = (iou[:, order], g_ig[order], areas, area_range, float(thr))
            got = ytvis._match_video(*args)
            assert_same(got, jax_ytvis._match_video(*args))
            scores = np.round(rng.rand(n_dt), 1)
            for n in (0, int((~g_ig).sum())):
                assert_same(ytvis._pr_curves(scores, got[0], got[1], n),
                            jax_ytvis._pr_curves(scores, got[0], got[1], n))


def test_avg_area_equals_jax():
    rng = np.random.RandomState(2)
    for masks in ([None, None], [np.zeros((4, 4))], list(blobs(rng, 5, 10, 12, 1)[0]) + [None]):
        assert_same(ytvis._avg_area(masks), jax_ytvis._avg_area(masks))


def test_ytvis_results_reader_on_the_port_writer_output(tmp_path):
    rng = np.random.RandomState(6)
    labels, counts, lifetimes = _labels(rng, 4, 16, 24, 4)
    logits = rng.randn(4, 16, 24, 41).astype(np.float32)
    writer = YoutubeVISOutputGenerator(str(tmp_path), device="cpu")
    writer.process_sequence(_Seq(7, (64, 96)), labels, counts, lifetimes, logits,
                            mask_scale=4, max_tracks=3, min_dim=64, max_dim=96)
    writer.save()
    path = str(tmp_path / "results.json")
    got = ytvis.load_ytvis_results_json(path)
    assert_same(got, jax_ytvis.load_ytvis_results_json(path))
    assert len(got) == 3 and got[0]["video"] == 7 and got[0]["masks"][0].shape == (64, 96)
    entries = json.loads((tmp_path / "results.json").read_text())
    assert np.array_equal(got[1]["masks"][2], rle.decode(entries[1]["segmentations"][2]))
