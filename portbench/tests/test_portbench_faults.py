"""The check on the CPU at a tiny size: a sound run of the program is
correct; the reference in bfloat16 in the program's place is not, and
neither is a run whose timed path is broken underneath."""

import numpy as np
import pytest

from conftest import tiny
from portbench import check
from portbench.harness import control, run_cell

#: calls a tiny run makes: a spread read from two calls of a film this
#: small swings too far for the noise check
CALLS = 6


class Broken:
    """Renderer.render with a fault planted in what it returns."""

    def __init__(self, renderer, fault):
        self.r, self.fault, self.first = renderer, fault, None

    def render(self, spp, tile, frame_base):
        if self.fault == "half_samples":
            # half the samples, their mean returned as the whole call's
            return self.r.render(spp=max(spp // 2, 1), tile=tile,
                                 frame_base=frame_base)
        img = self.r.render(spp=spp, tile=tile, frame_base=frame_base)
        if self.fault == "unchanged":
            # every call returns the state of the first
            if self.first is None:
                self.first = img
            return self.first.copy()
        if self.fault == "half_batch":
            # half the pixels of the batch left out
            flat = img.reshape(-1, 3).copy()
            flat[flat.shape[0] // 2:] = 0.0
            return flat.reshape(img.shape)
        if self.fault == "altered":
            # the answer altered where it is produced: channels rolled
            return np.roll(img, 1, axis=-1)
        raise ValueError(self.fault)


def _run(cell, wrap=None, seed=11):
    return run_cell(cell, seed, 0.5, False, device="cpu",
                    shrink=tiny(), wrap=wrap, log=lambda *_: None,
                    min_calls=CALLS)


def test_sound_run_is_correct(cornell_film):
    res = _run(cornell_film)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "half_samples",
                                   "altered"])
def test_broken_timed_path_is_not_correct(cornell_film, fault):
    res = _run(cornell_film, wrap=lambda r: Broken(r, fault))
    assert not res["correct"], (fault, res["check"])


def test_lower_precision_control_is_not_correct(cornell_film):
    numbers = control(cornell_film, 5, CALLS, device="cpu", shrink=tiny())
    assert not check.verdict(numbers)[0], numbers
