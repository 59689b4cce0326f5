"""A run with the timed path broken underneath comes out not correct; a
sound run and the control at a size a test run holds. The harness drives
everything but the look for a card, on the CPU, at the debug widths with
the program in float32 and the cells' own limits."""

import dataclasses

import pytest
import torch

from perfbench import calibrate
from perfbench.core import harness
from perfbench_small import small


def broken(fault: str):
    def make(cell, state, device):
        prog = harness.default_program(cell, state, device)
        call = prog.call

        def faulty(batch, seeds, syncs=None):
            out = call(batch, seeds, syncs)
            w, c, m, mc = out.warp.clone(), out.cert.clone(), out.matches, out.mcert
            if fault == "half_the_batch":     # the second half repeats the first
                h = w.shape[0] // 2
                w[h:], c[h:] = w[:h], c[:h]
                if m is not None:
                    m, mc = m.clone(), mc.clone()
                    m[h:], mc[h:] = m[:h], mc[:h]
            elif fault == "warp_altered":     # one pair's warp moved where it is made
                w[-1, ..., -2:] = (w[-1, ..., -2:] + 0.25).clamp(-1, 1)
            elif fault == "matches_altered":  # one pair's drawn matches moved
                m = m.clone()
                m[-1] += 1e-3
            return dataclasses.replace(out, warp=w, cert=c, matches=m, mcert=mc)

        prog.call = faulty
        return prog
    return make


CASES = [(cell, fault) for cell in ("roma-b2-s10k", "roma-b1-s10k", "tiny-b8-dense", "tiny-b8-s5k")
         for fault in ("half_the_batch", "warp_altered", "matches_altered")
         if not (fault == "half_the_batch" and cell == "roma-b1-s10k")
         and not (fault == "matches_altered" and cell == "tiny-b8-dense")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = harness.run(small(name), 31, 0.0, False, "cpu", 0.0, make_program=broken(fault))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", ["roma-b2-s10k", "roma-b1-s10k", "tiny-b8-dense", "tiny-b8-s5k"])
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    cell = small(name)
    assert harness.run(cell, 41, 0.0, False, "cpu", 0.0)["correct"] is True
    res = harness.run(cell, 41, 0.0, False, "cpu", 0.0, make_program=calibrate.control_program)
    assert res["correct"] is False, res["checks"]


def test_the_control_rounds_to_float8():
    from perfbench.reference.common import Precision

    x = torch.linspace(-3, 3, 1001)
    low = Precision("float8").low(x)
    err = (low - x).abs()
    assert err.max() > 0 and bool((err <= x.abs() / 16 + 1e-6).all())  # 3 mantissa bits
    assert torch.equal(Precision().low(x), x)
    assert 0 < (Precision("bfloat16").low(x) - x).abs().max() <= 3 / 256
