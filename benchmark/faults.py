"""Faults planted in the system under test, to show that a cell's
comparison catches them (its ``correct`` comes out false):

* ``answers_altered``: the fused path loses every second frame's answer
  (its labels all outliers);
* ``state_unchanged``: the optimizer step leaves the parameters as they
  were;
* ``half_batch``: half of each global batch is left out of the gradient
  and the mean is taken over the rest (one rank: every second micro-step;
  data parallel: the upper half of the ranks);
* ``exchange_left_out``: the ranks' gradients are not all-reduced.

``plant(name)`` patches this process; as a script,

    python3 benchmark/faults.py NAME <run.py's arguments>

plants ``NAME`` and runs the benchmark's entry point (the rank workers of
a data-parallel fault run).
"""

import os
import sys

FAULTS = ("answers_altered", "state_unchanged", "half_batch", "exchange_left_out")


def plant(name: str, setattr_=setattr) -> None:
    """Patches the program in this process (``setattr_``: a test's
    ``monkeypatch.setattr``)."""
    if name == "answers_altered":
        from stemseg_tpu_torch.inference import fused_pipeline as fp
        from stemseg_tpu_torch.inference.chainer import track_stats

        run = fp.FusedSequencePipeline.run

        def broken_run(self, *args, **kwargs):
            labels, _, _, fg, mc = run(self, *args, **kwargs)
            labels = labels.copy()
            labels[::2] = -1
            counts, lifetimes = track_stats(labels)
            return labels, counts, lifetimes, fg, mc

        setattr_(fp.FusedSequencePipeline, "run", broken_run)
    elif name == "state_unchanged":
        from stemseg_tpu_torch.training import step

        def no_update(self):
            if self.micro_step >= self.accumulate_steps:
                self.optimizer.zero_grad(set_to_none=True)
                self.micro_step = 0

        setattr_(step.TrainStep, "update", no_update)
    elif name == "half_batch":
        from stemseg_tpu_torch.training import step

        # a rank worker plants before it joins its group: the launcher's variables
        world, rank = int(os.environ.get("WORLD_SIZE", 1)), int(os.environ.get("RANK", 0))
        if world == 1:
            accumulate = step.TrainStep.accumulate

            def broken_accumulate(self, grads):
                if self.micro_step % 2:
                    self.micro_step += 1
                else:
                    accumulate(self, grads)

            setattr_(step.TrainStep, "accumulate", broken_accumulate)
        else:
            all_reduce = step.all_reduce_sum_

            def broken_all_reduce(tensors):
                tensors = list(tensors)
                for t in tensors:
                    t.mul_(0.0 if rank >= world // 2 else 2.0)
                all_reduce(tensors)

            setattr_(step, "all_reduce_sum_", broken_all_reduce)
    elif name == "exchange_left_out":
        from stemseg_tpu_torch.training import step

        setattr_(step, "all_reduce_sum_", lambda tensors: None)
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    plant(sys.argv[1])
    from benchmark import run as entry

    entry.main(sys.argv[2:])
