"""GL014 fixture: a serve-scoped scheduler loop parked on an unbounded
``queue.get()`` — an empty queue blocks the single writer thread with
no way to observe stop or wake events.  The bounded and non-blocking
forms below it stay silent."""
import queue
import threading

from magicsoup_tpu_torch import serve  # noqa: F401  (marks the module serve-scoped)

commands: queue.Queue = queue.Queue()
wake = threading.Event()


def loop_blocking(stop):
    while not stop.is_set():
        cmd = commands.get()  # GL014: unbounded wait wedges the loop
        cmd.run()


def loop_bounded(stop):
    while not stop.is_set():
        try:
            cmd = commands.get(timeout=0.5)  # bounded: stop stays visible
        except queue.Empty:
            continue
        cmd.run()


def loop_nonblocking(stop, defaults):
    while not stop.is_set():
        try:
            cmd = commands.get_nowait()  # non-blocking drain
        except queue.Empty:
            wake.wait(timeout=0.05)  # Event.wait is interruptible pacing
            continue
        cmd.run()
        _ = defaults.get("mode")  # dict-style get: not a queue wait
        _ = commands.get(block=False)  # explicit non-blocking form
