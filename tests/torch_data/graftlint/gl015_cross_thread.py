"""GL015 fixture: a metrics ring written by both the sampler thread and
ambient callers with no common lock — the classic torn-list race.  The
lock-guarded twin and the single-threaded class below stay silent."""
import threading


class RingSampler:
    """`samples` is appended from the sampler thread AND from public
    `record()` (any caller's thread) with no lock anywhere: flagged."""

    def __init__(self):
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="ring-sampler", daemon=True
        )

    def _run(self):
        while not self._stop.is_set():
            self.samples.append(self._probe())  # GL015: races record()
            self._stop.wait(timeout=0.01)

    def _probe(self):
        return 0

    def record(self, value):
        self.samples.append(value)


class LockedSampler:
    """Same shape, but every writer holds the same lock: clean."""

    def __init__(self):
        self.samples = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="locked-sampler", daemon=True
        )

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                self.samples.append(0)
            self._stop.wait(timeout=0.01)

    def record(self, value):
        with self._lock:
            self.samples.append(value)


class SingleThreaded:
    """No thread entry points at all — every write is ambient: clean."""

    def __init__(self):
        self.samples = []

    def record(self, value):
        self.samples.append(value)
