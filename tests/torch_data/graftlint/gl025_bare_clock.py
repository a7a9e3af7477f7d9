"""GL025 fixture: bare clock reading in a hot stepper-scoped function
whose measurement never reaches the telemetry plane."""
import time

from magicsoup_tpu_torch import stepper  # noqa: F401  (marks the module stepper-scoped)


# graftlint: hot
def step_timed(world, params, t0):
    out = world.step(params)
    world.last_step_s = time.perf_counter() - t0  # GL025: clock reading hoarded in local state
    return out
