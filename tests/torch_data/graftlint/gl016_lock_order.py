"""GL016 fixture: two locks taken in opposite nesting orders — two
threads running `credit()` and `audit()` concurrently deadlock, each
holding the lock the other wants.  The consistently-ordered class below
stays silent."""
import threading


class TransferLog:
    def __init__(self):
        self._accounts = threading.Lock()
        self._journal = threading.Lock()
        self.entries = []

    def credit(self):
        with self._accounts:
            with self._journal:
                self.entries.append("credit")

    def audit(self):
        with self._journal:
            with self._accounts:  # GL016: inverts credit()'s order
                self.entries.append("audit")


class ConsistentOrder:
    def __init__(self):
        self._outer = threading.Lock()
        self._inner = threading.Lock()
        self.entries = []

    def first(self):
        with self._outer:
            with self._inner:
                self.entries.append("first")

    def second(self):
        with self._outer:
            with self._inner:
                self.entries.append("second")
