"""Helpers of the port's test files: the port's prepared datasets held to
the reference's, and a bound on a call that joins a thread."""

import dataclasses
import threading

import numpy as np
import pytest

WAIT_TIMEOUT_S = 120    # a tiny checkpoint's write; past it the test fails


def assert_same_dataset(tds, jds):
    """Equal graph arrays and equal train/val/test splits."""
    for f in dataclasses.fields(jds.graph):
        np.testing.assert_array_equal(getattr(tds.graph, f.name),
                                      getattr(jds.graph, f.name),
                                      err_msg=f.name)
    for split in ("train", "val", "test"):
        for f in ("user", "item", "slot", "neg"):
            a = getattr(getattr(tds, split), f)
            b = getattr(getattr(jds, split), f)
            assert (a is None) == (b is None), (split, f)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{split}.{f}")


def untimed_meta(ds):
    """A dataset's meta with the prep's phases named but not timed: their
    wall times differ between two preps of the same data (a first prep
    may also build the native kernels)."""
    return dict(ds.meta, prep_phase_s=sorted(ds.meta["prep_phase_s"]))


def bounded(fn, *args, **kw):
    """fn(*args, **kw) on a daemon thread: a join inside it (such as
    CheckpointManager's of its writer thread) fails the test past
    WAIT_TIMEOUT_S instead of hanging; what fn raises is raised here."""
    err = []

    def run():
        try:
            fn(*args, **kw)
        except Exception as e:
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WAIT_TIMEOUT_S)
    if t.is_alive():
        pytest.fail(f"{fn.__qualname__} blocked past {WAIT_TIMEOUT_S} s")
    if err:
        raise err[0]
