"""The port's ``Timer``: an excluded call subtracts its time only from the
timers open around it. The CLI reads frames (excluded from "inference" and
"postprocessing") before either timed phase runs; that read must not eat
into the fps report."""

import time

from stemseg_tpu_torch.utils.timer import Timer

LOAD_S = 0.050
STEP_S = 0.005


@Timer.exclude_duration("inference", "postprocessing")
def _load():
    time.sleep(LOAD_S)


@Timer.log_duration("postprocessing")
def _step():
    time.sleep(STEP_S)


@Timer.log_duration("postprocessing")
def _step_with_inner_load():
    _load()
    time.sleep(STEP_S)


def test_exclusion_outside_the_timers_subtracts_nothing():
    Timer.reset()
    _load()
    _step()
    _load()
    assert Timer.get_duration("postprocessing") >= STEP_S
    assert Timer.get_duration("inference") == 0.0
    assert Timer.get_durations_sum() >= STEP_S


def test_exclusion_inside_a_timer_is_subtracted():
    Timer.reset()
    _step_with_inner_load()
    total = Timer._durations["postprocessing"]
    excluded = Timer._exclusions["postprocessing"]
    assert total >= LOAD_S + STEP_S
    assert excluded >= LOAD_S
    assert Timer.get_duration("postprocessing") == total - excluded
    assert STEP_S <= Timer.get_duration("postprocessing") <= total - LOAD_S
    # "inference" was not open around the load: nothing subtracted from it
    assert Timer._exclusions["inference"] == 0.0
