"""GL022 fixture: a builtin exception that can propagate out of a
warden hook untyped — the policy layer above dispatches on the typed
guard errors and would only see a stack trace.  The typed raise, the
locally-caught builtin, and the constructor validation below it stay
silent."""
from magicsoup_tpu_torch.guard.errors import GuardConfigError


class MiniWarden:
    def __init__(self, cadence: int):
        if cadence < 1:
            raise ValueError("cadence must be >= 1")  # ctor validation

    def before_step(self, step: int) -> None:
        _check_cadence(step)

    def after_step(self, step: int) -> None:
        try:
            _check_cadence(step)
        except ValueError:
            pass  # caught before it can escape the hook

    def configure(self, cadence: int) -> None:
        if cadence < 1:
            raise GuardConfigError(  # typed: the layer above dispatches
                "cadence must be >= 1",
                variable="cadence",
                value=str(cadence),
            )


def _check_cadence(step):
    if step < 0:
        raise ValueError(f"negative step {step}")  # GL022: escapes untyped
