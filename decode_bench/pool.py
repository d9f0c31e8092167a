"""A pool of worker processes that talk over pipes.

`run_pool(("module", "function"), args, workers)` is
`[module.function(a) for a in args]`, the arguments dealt out in turn to
`workers` fresh interpreters running this file, each with this folder
first on its path.  Jobs and results travel as pickles over the
workers' standard input and output (the workers' own prints go to
standard error), so the pool leaves nothing behind: no named semaphore
in /dev/shm, no file, and every worker has ended when it returns.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _call(func: tuple, args: list) -> list:
    f = getattr(importlib.import_module(func[0]), func[1])
    return [f(a) for a in args]


def run_pool(func: tuple, args: list, workers: int) -> list:
    """[func(a) for a in args], over min(workers, len(args)) processes."""
    n = min(workers, len(args))
    if n <= 1:
        return _call(func, args)
    shares = [list(range(i, len(args), n)) for i in range(n)]
    procs = []
    try:
        for share in shares:
            p = subprocess.Popen([sys.executable, __file__],
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE)
            procs.append(p)
            p.stdin.write(pickle.dumps((func, [args[i] for i in share])))
            p.stdin.close()
        out: list = [None] * len(args)
        for p, share in zip(procs, shares):
            data = p.stdout.read()
            if p.wait() != 0:
                raise RuntimeError(f"a pool worker for {func} exited with "
                                   f"{p.returncode}")
            for i, r in zip(share, pickle.loads(data)):
                out[i] = r
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _worker() -> None:
    sys.path.insert(0, HERE)
    func, args = pickle.load(sys.stdin.buffer)
    # the results get the pipe; whatever else writes to fd 1 goes to 2
    result_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    result = _call(func, args)
    with os.fdopen(result_fd, "wb") as f:
        f.write(pickle.dumps(result))


if __name__ == "__main__":
    _worker()
