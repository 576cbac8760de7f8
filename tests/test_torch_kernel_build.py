"""The kernel build across processes (``trino_tpu_torch/ops/cuda_kernels.py``
``build_kernels``): worker processes that start together on an empty build
directory each compile into temporary files of their own, so every
``os.replace`` stays atomic and each process ends with one loadable library
per source.

There is no ``nvcc`` here: a stand-in ``nvcc`` (``CUDA_HOME``/bin/nvcc) turns
each ``.cu`` into a shared library exporting that source's C entries with
the host C compiler, after a pause that makes the two builds overlap.  Two
processes are released at once on one build directory; both must load all
four libraries, and the directory must end with one library and one report
per source and no temporary file.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

from trino_tpu_torch.ops import cuda_kernels as ck

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = textwrap.dedent('''\
    #!{python}
    import json, os, subprocess, sys, tempfile, time
    args = sys.argv[1:]
    out, src = args[args.index("-o") + 1], args[-1]
    entries = json.loads(os.environ["STUB_ENTRIES"])[os.path.basename(src)]
    time.sleep(1.0)  # the two builds overlap
    with tempfile.NamedTemporaryFile("w", suffix=".c", delete=False) as f:
        f.write("".join(f"int {{e}}(void) {{{{ return 0; }}}}\\n" for e in entries))
    subprocess.run(["cc", "-shared", "-fPIC", "-o", out, f.name], check=True)
    os.unlink(f.name)
    print(f"ptxas info    : stand-in build of {{os.path.basename(src)}}")
''')

CHILD = textwrap.dedent('''\
    import os, sys, time
    from trino_tpu_torch.ops import cuda_kernels as ck
    ck._BUILD = sys.argv[1]
    while not os.path.exists(sys.argv[2]):
        time.sleep(0.01)
    ck.build_kernels()
    assert all(e in ck._entries for e in ck._SIGNATURES)
    print("built", os.getpid())
''')


def test_two_processes_build_into_one_directory(tmp_path):
    assert shutil.which("cc"), "the stand-in nvcc needs the host C compiler"
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable))
    nvcc.chmod(0o755)
    entries: dict = {}
    for entry, (src, _args) in ck._SIGNATURES.items():
        entries.setdefault(src, []).append(entry)
    build, go = tmp_path / "build", tmp_path / "go"
    env = dict(os.environ, CUDA_HOME=str(home), STUB_ENTRIES=json.dumps(entries),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(build), str(go)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    time.sleep(0.5)
    go.write_text("")  # both start at once
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("built")
    names = sorted(os.listdir(build))
    assert not [n for n in names if n.endswith(".tmp")], names
    libs = [n for n in names if n.endswith(".so")]
    assert len(libs) == len(entries) and len([n for n in names if n.endswith(".log")]) \
        == len(entries), names
    for src, want in entries.items():
        (lib,) = [n for n in libs if n.startswith(src[:-3] + "_")]
        assert lib == f"{src[:-3]}_{ck.source_digest(os.path.join(ck._CSRC, src))}.so"
        handle = ctypes.CDLL(str(build / lib))
        for entry in want:
            assert getattr(handle, entry)() == 0
