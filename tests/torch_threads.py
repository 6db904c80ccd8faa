"""One BLAS thread while a port test module runs.

numpy's and scipy's OpenBLAS start a thread for every core by default. The
suite's workers share the machine's cores, and the JAX references' and the
port's host linear algebra spent several times the CPU for the same or a
longer wall time: ``test_torch_compress.py::test_plan_and_factors_match_jax
[mha-basis]`` took 38.7 s of CPU in 12.1 s alone, and 7.8 s in 6.2 s with
one thread. Each port test module imports ``one_blas_thread``, an autouse
fixture that holds every BLAS library loaded in the process to one thread
while the module's tests and fixtures run and restores the limits after,
so the other test files of the same worker run as they did. (torch's own
intra-op pool is held to one thread by each module.)
"""
import pytest
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield
