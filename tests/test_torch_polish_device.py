"""The f64 SQUAREM polish on the device (``solver.polish_device``, run
here on CPU tensors through the kernels' plain versions) against the
host's C++ polish (``solver.polish_host_f64``): the same cycles and stop
under the host polish's rules (a stop test every cycle, no stop on a NaN
gain, the cycle cap), logL within rel 1e-10 and segment intensities
within rtol 1e-7.  The card runs the same comparison in
``tests/test_torch_loop_cuda.py``."""

import numpy as np
import pytest
import torch

from emsar_tpu_torch.model import loop
from emsar_tpu_torch.model import solver as tsolver
from torch_loop_cases import (POLISH_CAPS, POLISH_CASES, POLISH_EPSILON,
                              check_polish, first_stop_gain, polish_case)

# test workers share the machine's cores: one intra-op thread each keeps
# the many tiny torch ops of the cycles from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("max_cycles", POLISH_CAPS)
@pytest.mark.parametrize("case", POLISH_CASES)
def test_device_polish_matches_host(monkeypatch, case, max_cycles):
    """With the stop flag read every 4 blocks (the default) and every 3,
    so that masked cycles run after the stop, the device polish runs the
    host polish's cycles to its answer."""
    problem, theta = polish_case(case)
    cycles = check_polish(problem, theta, max_cycles)
    monkeypatch.setattr(loop, "CHECK_EVERY", 3)
    assert check_polish(problem, theta, max_cycles) == cycles
    if case == "one_cycle":
        assert cycles == 1
    elif max_cycles == 2:
        assert cycles == 2  # the cap
    else:
        assert 2 < cycles < max_cycles
    if case == "nan_gain":
        # em_solve's stop test (gain >= epsilon) ends on this NaN; the
        # polish's (gain < epsilon) runs on
        assert np.isnan(first_stop_gain(problem, theta))


def test_device_polish_cap_zero_runs_nothing():
    problem, theta = polish_case("stop")
    p = tsolver.problem_to_device(problem, torch.device("cpu"),
                                  torch.float64)
    got, cycles = tsolver.polish_device(p, torch.as_tensor(theta),
                                        POLISH_EPSILON, 0)
    assert cycles == tsolver.polish_host_f64(problem, theta,
                                             POLISH_EPSILON, 0)[1] == 0
    np.testing.assert_array_equal(got.numpy(), theta)
