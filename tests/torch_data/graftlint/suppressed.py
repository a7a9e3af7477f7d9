"""Suppression fixture: same GL004 violation as gl004_nondet.py, but
annotated — must produce zero findings."""
import time


def stamp():
    return time.time()  # graftlint: disable=GL004 telemetry only
