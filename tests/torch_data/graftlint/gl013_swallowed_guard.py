"""GL013 fixture: a guard-scoped module whose broad ``except`` eats the
typed guard errors — a refused checkpoint or tripped sentinel continues
as if nothing happened.  The specific-catch and re-raise forms right
below it stay silent."""
from magicsoup_tpu_torch.guard.errors import CheckpointError  # noqa: F401  (marks the module guard-scoped)


def load_or_default(manager, default):
    try:
        payload, _meta, _path = manager.load_latest()
    except Exception:  # GL013: swallows the typed guard errors
        payload = default
    return payload


def load_specific(manager, default):
    try:
        payload, _meta, _path = manager.load_latest()
    except CheckpointError:
        payload = default  # reacting to the TYPED error is the point
    return payload


def load_reraise(manager):
    try:
        return manager.load_latest()
    except Exception as exc:
        raise CheckpointError(str(exc), check="none") from exc
