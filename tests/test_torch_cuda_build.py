"""The first-use kernel build under threads (``ops/cuda_build.py``).

A server launches kernels from its device loop and its request threads,
so the first use of a library can come from several threads at once.
Here ``nvcc`` is stood in for by a script that counts its calls and
builds a trivial shared library with ``g++``; eight threads then load one
library at once: one build, one loaded library, the temporary outputs
named per process and thread.  A build or launch that fails raises
``KernelError``, which serving classifies as permanent, and a failed
build is not run again.
"""

import os
import shutil
import stat
import sys
import threading

import pytest

from distributed_sudoku_solver_tpu_torch.ops import cuda_build

FAKE_NVCC = r'''#!/bin/sh
# Stand-in for nvcc: count the call, then build a trivial library at -o.
echo "$@" >> "{log}"
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
sleep 0.3
printf 'extern "C" int dsst_fake(void) {{ return 7; }}\n' > "$out.cc"
exec g++ -shared -fPIC -o "$out" "$out.cc"
'''


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH")
    log = tmp_path / "nvcc_calls.log"
    script = tmp_path / "nvcc"
    script.write_text(FAKE_NVCC.format(log=log))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_failed", {})
    return log


def test_eight_threads_one_build_one_library(fake_toolchain):
    barrier = threading.Barrier(8)
    libs, errors = [], []

    def load():
        try:
            barrier.wait()
            libs.append(cuda_build.load("propagate"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    calls = fake_toolchain.read_text().splitlines()
    assert len(calls) == 1, calls
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
    assert libs[0].dsst_fake() == 7
    # The temporary output was named by process and thread, then renamed.
    tmp = calls[0].split(" -o ")[1].split()[0]
    assert f".tmp{os.getpid()}-" in tmp and not os.path.exists(tmp)
    assert cuda_build.lib_path("propagate").exists()
    assert cuda_build.load("propagate") is libs[0]  # cached, no new build
    assert len(fake_toolchain.read_text().splitlines()) == 1


def test_build_and_load_from_two_threads(fake_toolchain):
    """``build`` of every target on one thread while another loads one:
    each library is built once."""
    done = []
    t = threading.Thread(target=lambda: done.append(cuda_build.build(
        (("propagate", ""), ("fused_step", "")))))
    t.start()
    lib = cuda_build.load("fused_step")
    t.join(120)
    assert not t.is_alive()
    calls = fake_toolchain.read_text().splitlines()
    assert len(calls) == 2, calls
    assert lib.dsst_fake() == 7


def test_failed_build_raises_kernel_error_once(fake_toolchain, tmp_path, monkeypatch):
    """nvcc exiting nonzero raises ``KernelError`` from ``load``, from
    every thread that asked; a later ``load`` raises it again without a
    second nvcc, so a server whose kernel cannot build does not rebuild
    per request."""
    from distributed_sudoku_solver_tpu_torch.serving import faults

    script = tmp_path / "nvcc_fails"
    script.write_text(f'#!/bin/sh\necho "$@" >> "{fake_toolchain}"\n'
                      'echo "error: simulated" >&2\nexit 1\n')
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(script))
    errors = []

    def load():
        try:
            cuda_build.load("fused_step")
        except Exception as e:  # noqa: BLE001 - checked below
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(errors) == 4
    assert all(isinstance(e, cuda_build.KernelError) for e in errors), errors
    assert "simulated" in str(errors[0])
    assert all(faults.classify(e) == faults.PERMANENT for e in errors)
    with pytest.raises(cuda_build.KernelError):
        cuda_build.load("fused_step")
    assert len(fake_toolchain.read_text().splitlines()) == 1
    assert not cuda_build.lib_path("fused_step").exists()


def test_launch_error_is_a_permanent_kernel_error():
    from distributed_sudoku_solver_tpu_torch.serving import faults

    cuda_build.check(0, "dsst_fused_rounds")
    with pytest.raises(cuda_build.KernelError, match="dsst_fused_rounds: CUDA error 9") as e:
        cuda_build.check(9, "dsst_fused_rounds")
    assert faults.classify(e.value) == faults.PERMANENT
    assert faults.classify_message(f"KernelError: {e.value}") == faults.PERMANENT
