"""One share of the machine's cores for each pytest-xdist worker.

Every `tests/test_torch_*.py` imports this module first. Under xdist each
worker imports every test module while it collects, so the first import
caps the whole worker, the JAX tests it runs included, before any test
runs. Without xdist it does nothing, and a run keeps every core.

A worker that loads torch holds torch's OpenMP pool, MKL's and numpy's
OpenBLAS (which spins while it waits), each as wide as the machine; six
such workers on eight cores spend most of their time contending. The cap
is applied three ways, since each reaches pools the others miss:
  - the `*_NUM_THREADS` variables, read by libraries loaded later (scipy's
    and sklearn's BLAS and OpenMP) and by the subprocesses tests spawn;
  - `threadpoolctl`, for the BLAS and OpenMP pools already loaded;
  - `torch.set_num_threads`, for torch's intra-op pool in every thread,
    threads started later included (threadpoolctl's OpenMP limit holds
    only in the thread that set it).
"""

import os


def _cap() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    n = max(1, (os.cpu_count() or 1) // int(workers))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(n)

    import torch
    from threadpoolctl import threadpool_limits

    threadpool_limits(n)
    torch.set_num_threads(n)


_cap()
