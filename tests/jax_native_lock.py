"""Builds the JAX package's C++ library under an exclusive file lock when
first imported. The port's test modules that run the JAX package import
it before anything else.

tiler_tpu/native compiles its library straight onto the final path at
first use, so a second test process that loads the file while the first
is still writing it fails on a truncated library and keeps that failure
for the rest of its run. Test collection imports the test modules in
every pytest-xdist worker, and xdist starts no test until every worker
has collected, so the library is whole before the first test of any
worker loads it: the first worker builds it while the others wait on the
lock, then they find it up to date and load it.

A module collected before the port's (tests/test_bitstream.py asks
native.available() in its decorators) may have made that first use
without the lock and read a half-written file. Such a process builds a
whole copy of its own under build/ and loads that one instead."""
import fcntl
import os

import tiler_tpu.native as _jnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_jax_native_library() -> None:
    build = os.path.join(REPO, 'build')
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, 'tiler_native.lock'), 'w') as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if _jnative._build_error is not None:
                _jnative._SO_PATH = os.path.join(
                    build, f'tiler_tpu_native.{os.getpid()}.so')
                _jnative._build_error = None
            _jnative.get_lib()
        except Exception:  # noqa: BLE001  (the tests that need it report it)
            pass
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


build_jax_native_library()
