"""One computation of a module fixture's reference for a whole xdist run.

Under ``pytest -n N --dist load`` each worker that draws a test of a module
sets its module fixtures up on its own, so a fixture that runs the JAX
reference (or a gloo world) runs once per such worker, each copy competing
with the others for the same cores. :func:`shared` runs ``compute()`` in
the first worker that asks and pickles its value under the run's shared
temporary directory, keyed by the xdist run id; a worker asking while it
runs waits on a file lock, then loads the value. The tests compare
against exactly what they would have computed themselves. Without xdist it
is ``compute()``. The value must pickle: numpy arrays, torch tensors,
plain containers.
"""

import fcntl
import os
import pickle


def shared(tmp_path_factory, name, compute):
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return compute()
    root = tmp_path_factory.getbasetemp().parent / f"shared-{run}"
    root.mkdir(exist_ok=True)
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = compute()
            tmp = root / f"{name}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
