"""The kernels' build lock: processes that build at once (the ranks of a
mesh) share one build directory and compile each library once. A stand-in
``nvcc`` (there is no CUDA toolkit on the test machine) logs each call and
writes its output after a pause long enough that, without the lock, the
second process would find the libraries missing and compile them again."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from repro_torch.kernels import _cuda

ROOT = Path(__file__).resolve().parents[1]

STAND_IN = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open({log!r}, "a") as f:
        f.write(f"{{os.getppid()}} {{os.path.basename(sys.argv[-1])}}\\n")
    time.sleep(2.0)
    with open(out, "w") as f:
        f.write("not a library")
    """)

BUILD = ("import sys; from pathlib import Path; "
         "from repro_torch.kernels import _cuda; "
         "_cuda.BUILD_ROOT = Path(sys.argv[1]); "
         "print(_cuda.build_dir()); print(sorted(_cuda.build_all()))")


def test_two_processes_build_each_library_once(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STAND_IN.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    root = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(root)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    dirs = {o.splitlines()[0] for o, _ in outs}
    built = [eval(o.splitlines()[1]) for o, _ in outs]
    assert len(dirs) == 1                     # one build directory
    d = Path(dirs.pop())
    assert d.parent == root
    calls = log.read_text().split()[1::2]
    assert sorted(calls) == sorted(f"{n}.cu" for n in _cuda.SOURCES)
    assert sorted(map(len, built)) == [0, len(_cuda.SOURCES)]
    assert sorted(p.name for p in d.glob("*.so")) == sorted(
        f"lib{n}.so" for n in _cuda.SOURCES)
