"""Accuracy runbook: infer -> score, per dataset, through the port's CLIs.

    python -m stemseg_tpu_torch.tools.eval_all --models_dir CKPTS --output_dir OUT \
        [--datasets davis ytvis kittimots] [--bf16] [--seqs SEQ ...] \
        [--frame_overlap N] [--device cuda]

For each dataset asked for:

1. **convert**: none needed; the inference CLI reads a ``.pth`` (a
   reference state dict or a port trainer's checkpoint) and a JAX package
   ``.ckpt`` as they are (``python -m stemseg_tpu_torch.models.convert_checkpoint``
   turns a ``.ckpt`` into a ``.pth`` once);
2. **infer**: ``stemseg_tpu_torch.inference.main`` on ``--device`` with the
   dataset's config resolution (``config.yaml`` beside the checkpoint, else
   the dataset's preset), writing the official submission formats into
   ``OUT/<dataset>/``;
3. **score**: ``stemseg_tpu_torch.eval.main`` on the written results against
   the ground-truth JSONs (DAVIS J&F with recall and decay; YouTube-VIS AP,
   AP50, AP75, AP_S / M / L, AR@1, AR@10; KITTI-MOTS sMOTSA, MOTSA, MOTSP per
   class and pooled), on the host.

``--models_dir`` holds ``davis``, ``youtube_vis`` and ``kitti_mots``
checkpoints (``.pth`` tried before ``.ckpt``). The inference CLI reads the
``config.yaml`` beside a checkpoint, so one in ``--models_dir`` serves every
checkpoint there, and without one each dataset's preset is used: models of
other configs go in dirs of their own, a run each.
Dataset roots come from ``DAVIS_BASE_DIR``, ``YOUTUBE_VIS_BASE_DIR``,
``KITTIMOTS_BASE_DIR`` and ``STEMSEG_JSON_ANNOTATIONS_DIR``
(``stemseg_tpu_torch/data/paths.py``); a dataset asked for whose variables
or checkpoint are missing is an error. Both steps are timed (host clock;
inference ends in the writer's ``save()``). Writes ``OUT/RESULTS.md`` with
each dataset's metrics and times, and prints one JSON line of the metrics.

The YT-VIS scorer needs ground-truth tracks, so it scores against a
validation JSON that has masks; the official server takes the
``results.zip`` written beside ``results.json`` as it is.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# dataset -> (checkpoint names tried in order, environment variables needed)
DATASETS = {
    "davis": (("davis.pth", "davis.ckpt"),
              ("DAVIS_BASE_DIR", "STEMSEG_JSON_ANNOTATIONS_DIR")),
    "ytvis": (("youtube_vis.pth", "youtube_vis.ckpt"),
              ("YOUTUBE_VIS_BASE_DIR", "STEMSEG_JSON_ANNOTATIONS_DIR")),
    "kittimots": (("kitti_mots.pth", "kitti_mots.ckpt"),
                  ("KITTIMOTS_BASE_DIR", "STEMSEG_JSON_ANNOTATIONS_DIR")),
}

RESULTS_HEADER = """# Accuracy results

Produced by ``python -m stemseg_tpu_torch.tools.eval_all`` on {date}, inference on
``{device}``, scoring on the host. Checkpoints: ``{models_dir}``.
"""


def find_checkpoint(models_dir: str, dataset: str) -> str:
    names = DATASETS[dataset][0]
    for name in names:
        path = os.path.join(models_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"{dataset}: none of {list(names)} in {models_dir}")


def run_dataset(dataset: str, ckpt: str, out_root: str, args) -> dict:
    """Inference, then scoring, of one dataset. Returns its metrics, the
    seconds of each step and the output dir."""
    from stemseg_tpu_torch.eval.main import main as eval_main
    from stemseg_tpu_torch.inference import main as inference_main
    from stemseg_tpu_torch.utils.timer import Timer

    out_dir = os.path.join(out_root, dataset)
    cli = [ckpt, "-o", out_dir, "--dataset", dataset, "--device", args.device]
    if args.bf16:
        cli.append("--bf16")
    if args.seqs:
        cli += ["--seqs"] + list(args.seqs)
    if args.frame_overlap is not None:
        # a model of fewer frames than the dataset's default overlap needs one
        cli += ["--frame_overlap", str(args.frame_overlap)]

    Timer.reset()
    t0 = time.perf_counter()
    inference_main.main(cli)
    inference_s = time.perf_counter() - t0

    results = os.path.join(out_dir, "results.json" if dataset == "ytvis" else "results")
    eval_cli = ["--dataset", dataset, "--results", results]
    if args.seqs:
        eval_cli += ["--seqs"] + list(args.seqs)
    t0 = time.perf_counter()
    metrics = eval_main(eval_cli)
    scoring_s = time.perf_counter() - t0
    return {"metrics": metrics, "inference_s": inference_s, "scoring_s": scoring_s,
            "output_dir": out_dir}


def write_results_md(path: str, models_dir: str, device: str, per_dataset: dict):
    lines = [RESULTS_HEADER.format(date=time.strftime("%Y-%m-%d %H:%M"), device=device,
                                   models_dir=models_dir)]
    for ds, res in per_dataset.items():
        lines.append(f"\n## {ds}\n")
        lines.append(f"Inference {res['inference_s']:.3f} s, scoring {res['scoring_s']:.3f} s "
                     f"-> ``{res['output_dir']}``\n")
        lines.append("| Metric | Value |")
        lines.append("|---|---|")
        for k, v in res["metrics"].items():
            lines.append(f"| {k} | {v:.4f} |" if isinstance(v, float) else f"| {k} | {v} |")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--models_dir", required=True,
                        help="directory with davis / youtube_vis / kitti_mots .pth "
                             "or .ckpt checkpoints")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--datasets", nargs="*", default=list(DATASETS), choices=list(DATASETS))
    parser.add_argument("--seqs", nargs="*", help="only these sequence ids")
    parser.add_argument("--bf16", action="store_true", help="the model forward in bfloat16")
    parser.add_argument("--frame_overlap", type=int, default=None,
                        help="the window overlap (below the model's num_frames)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the inference; 'cpu' runs the "
                             "plain versions of the kernels")
    args = parser.parse_args(argv)

    plan = {}
    for ds in args.datasets:
        missing = [v for v in DATASETS[ds][1] if not os.environ.get(v)]
        if missing:
            parser.error(f"{ds}: environment variables not set: {missing}")
        plan[ds] = find_checkpoint(args.models_dir, ds)

    os.makedirs(args.output_dir, exist_ok=True)
    per_dataset = {}
    for ds, ckpt in plan.items():
        print(f"[eval_all] {ds}: {ckpt}", flush=True)
        per_dataset[ds] = run_dataset(ds, ckpt, args.output_dir, args)

    write_results_md(os.path.join(args.output_dir, "RESULTS.md"), args.models_dir,
                     args.device, per_dataset)
    print(json.dumps({ds: res["metrics"] for ds, res in per_dataset.items()}))
    return per_dataset


if __name__ == "__main__":
    main()
