"""GL017 fixture: an HTTP handler mutating fleet state directly instead
of submitting a command through the service queue — the single-writer
serve contract.  The queue-routed and read-only handlers below stay
silent."""
from magicsoup_tpu_torch import serve  # noqa: F401  (marks the module serve-scoped)


class BypassHandler:
    """do_POST reaches into the scheduler from the handler thread."""

    service = None

    def do_POST(self):
        self.service.scheduler.admit("tenant")  # GL017: bypasses the queue

    def do_GET(self):
        return self.service.health()


class QueueHandler:
    """Commands routed through submit(): clean."""

    service = None

    def do_POST(self):
        return self.service.submit("create", {"label": "tenant"})

    def do_DELETE(self):
        return self.service.submit("detach", {"tenant": "tenant"})
