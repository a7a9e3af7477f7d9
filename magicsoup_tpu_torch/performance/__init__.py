"""
The port's diagnostic benchmarks of the integrator kernel, run as
modules:

- :mod:`~magicsoup_tpu_torch.performance.kernel_bisect`: the ladder of
  the integrator body's sub-expressions, each as its own kernel, against
  its plain version and its byte bound;
- :mod:`~magicsoup_tpu_torch.performance.integrator_bench`: the
  integrator's time per step by backend and world count.

Both run on the card unless ``--device cpu`` is passed.
"""
import statistics
import subprocess

import torch

#: H100 SXM memory rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_name(device: torch.device) -> str:
    """``torch.cuda.get_device_name`` for a CUDA device, else ``"cpu"``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


#: cycles the card spins before each timed run (about 1 ms on an H100),
#: so that the host has enqueued the run before its start event fires
SPIN_CYCLES = 2_000_000


def cuda_median_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, each between two CUDA events on the current stream.  Before
    each run the card spins for ``SPIN_CYCLES``, so a run whose host
    enqueue takes less than that is timed by its device work alone, not
    by the host's time to launch it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
