"""The port's one-k pipeline end to end against megahit_tpu's.

Both CLIs run --k-list 21 on the make_test_data fixtures under a
temporary directory (megahit_tpu on the JAX CPU backend, the port with
--device cpu). final.contigs.fa must be byte-identical, and so must every
artifact the run leaves behind; each package also reads the other's
artifacts. The rest covers the entry points: empty input, --continue,
the refusal of an invalid k list, the default device, and that the port
never imports JAX or megahit_tpu."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from megahit_tpu.__main__ import main as jax_main
from megahit_tpu.io import contig_io as jcio
from megahit_tpu.io import lib as jlib
from megahit_tpu_torch import convert
from megahit_tpu_torch.__main__ import main as torch_main
from megahit_tpu_torch.graph.mercy import find_mercy_edges
from megahit_tpu_torch.graph.sdbg import Sdbg, sdbg_from_edges
from megahit_tpu_torch.io import contig_io as tcio
from megahit_tpu_torch.io import lib as tlib
from megahit_tpu_torch.pipeline.driver import Pipeline
from megahit_tpu_torch.pipeline.options import Options

import torch_test_env  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "megahit_tpu_torch"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each package on the fixtures, tmp files kept."""
    d = tmp_path_factory.mktemp("fixtures")
    j, t = d / "jax", d / "torch"
    assert jax_main(["--test", "--k-list", "21", "--keep-tmp-files",
                     "-o", str(j)]) == 0
    assert torch_main(["--test", "--k-list", "21", "--keep-tmp-files",
                       "--device", "cpu", "-o", str(t)]) == 0
    return j, t


def _files(root: pathlib.Path, pattern: str) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.glob(pattern))


def test_final_contigs_byte_identical(runs):
    j, t = runs
    want = (j / "final.contigs.fa").read_bytes()
    assert want.count(b">") > 0
    assert (t / "final.contigs.fa").read_bytes() == want
    names = _files(j, "intermediate_contigs/*")
    assert names and _files(t, "intermediate_contigs/*") == names
    for name in names:
        assert (t / name).read_bytes() == (j / name).read_bytes(), name


def test_artifacts_equal_and_interoperate(runs, tmp_path):
    j, t = runs
    # the count's histogram and edge file
    assert (t / "tmp/k21/k21.counting").read_bytes() == \
        (j / "tmp/k21/k21.counting").read_bytes()
    ej, et = np.load(j / "tmp/k21/k21.edges.npz"), \
        np.load(t / "tmp/k21/k21.edges.npz")
    assert sorted(ej.files) == sorted(et.files)
    for f in ej.files:
        np.testing.assert_array_equal(et[f], ej[f], f)
    # the read library, written by each and loaded by the other
    for path in (j / "reads.lib.npz", t / "reads.lib.npz"):
        a, b = tlib.SequenceLib.load(str(path)), \
            jlib.SequenceLib.load(str(path))
        np.testing.assert_array_equal(a.starts, b.starts)
        assert a.lib_ranges == b.lib_ranges
        np.testing.assert_array_equal(a.flat_codes, b.flat_codes)
    zj, zt = np.load(j / "reads.lib.npz"), np.load(t / "reads.lib.npz")
    for f in zj.files:
        np.testing.assert_array_equal(zt[f], zj[f], f)
    # contig FASTA: each package reads the other's and writes it back
    for path, reader, writer in (
            (j / "final.contigs.fa", tcio.read_contigs, tcio.write_contigs),
            (t / "final.contigs.fa", jcio.read_contigs,
             jcio.write_contigs)):
        out = tmp_path / "round_trip.fa"
        writer(str(out), reader(str(path)))
        assert out.read_bytes() == path.read_bytes()


def test_realistic_reads_byte_identical(tmp_path):
    """Illumina-like gz FASTQ pairs (error ramp, adapters, N calls,
    duplicates, truncated reads) from the repo's generator: both
    packages give the same contigs."""
    data = tmp_path / "reads"
    subprocess.run([sys.executable, str(ROOT / "scripts/make_realistic.py"),
                    str(data), "--genome-bp", "30000", "--coverage", "20",
                    "--seed", "3"], check=True, capture_output=True,
                   timeout=120)
    args = ["-1", str(data / "reads_1.fq.gz"), "-2",
            str(data / "reads_2.fq.gz"), "--k-list", "21"]
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_main(args + ["--device", "cpu",
                              "-o", str(tmp_path / "torch")]) == 0
    want = (tmp_path / "jax/final.contigs.fa").read_bytes()
    assert want.count(b">") > 0
    assert (tmp_path / "torch/final.contigs.fa").read_bytes() == want


def test_empty_input_completes(tmp_path):
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    outs = []
    for name, run, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        out = tmp_path / name
        assert run(["-r", str(empty), "--k-list", "21", "-o", str(out)]
                   + extra) == 0
        assert (out / "done").exists()
        outs.append((out / "final.contigs.fa").read_bytes())
    assert outs[0] == outs[1] == b""


def test_continue_resumes(runs, tmp_path):
    """A run stopped after the count resumes with --continue: the
    finished stages are skipped and the contigs are the same."""
    _, t = runs
    out = tmp_path / "resume"
    assert torch_main(["--test", "--k-list", "21", "--keep-tmp-files",
                       "--device", "cpu", "-o", str(out)]) == 0
    want = (out / "final.contigs.fa").read_bytes()
    assert want == (t / "final.contigs.fa").read_bytes()
    (out / "checkpoints.txt").write_text("0 done\n1 done\n")
    (out / "final.contigs.fa").unlink()
    (out / "done").unlink()
    assert torch_main(["--continue", "--device", "cpu",
                       "-o", str(out)]) == 0
    assert (out / "final.contigs.fa").read_bytes() == want
    log = (out / "log").read_text()
    assert "skipping checkpointed stage 1 (stage_first_graph)" in log
    assert "stage 2 (stage_assemble 21)" in log


@pytest.mark.parametrize("flags", [["--k-list", "21,51"],
                                   ["--k-min", "21", "--k-max", "42"],
                                   ["--k-list", "13,21"]])
def test_multi_k_refused(flags, tmp_path, capsys):
    """A multi-k list runs the ladder (tests/test_torch_ladder.py); one
    that breaks the reference's k constraints (a step above 28, an even
    k, k below 15; src/megahit:523-542) is refused before any stage
    runs, as megahit_tpu refuses it."""
    out = tmp_path / "multi"
    assert torch_main(["--test", "--device", "cpu", "-o", str(out)]
                      + flags) == 1
    err = capsys.readouterr().err
    assert "exceeds 28" in err or "k must be odd, in [15, 255]" in err
    assert not (out / "final.contigs.fa").exists()
    assert jax_main(["--test", "-o", str(tmp_path / "jax")] + flags) == 1


def test_default_device_is_cuda(tmp_path):
    """The entry points run on CUDA unless asked for the CPU; without a
    card they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "dflt"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--test", "--k-list", "21", "-o", str(out)])
    assert not out.exists()
    assert Options().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(Options(se=["x.fa"], k_list=[21], out_dir=str(out)))
    # the library's graph entry points default to cuda as well
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 1 << 32, (8, 2), dtype=np.uint64)
                   .astype(np.uint32), axis=0)
    mults = np.full(8, 3, np.int32)
    g = sdbg_from_edges(keys, mults, 21, device="cpu")
    g.save(str(tmp_path / "g.sdbg.npz"))
    for call in (
        lambda: sdbg_from_edges(keys, mults, 21),
        lambda: sdbg_from_edges(keys[:0], mults[:0], 21),
        lambda: Sdbg.load(str(tmp_path / "g.sdbg.npz")),
        lambda: Sdbg(21, g.keys, g.mult),
        lambda: convert.sdbg(21, g.keys, g.mult, g.valid),
        lambda: find_mercy_edges(np.zeros(100, np.uint8),
                                 np.array([0, 100]), keys, 21),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _is_reference(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "megahit_tpu")


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(filter(
        _is_reference, _imported_modules(f))) for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_port_runs_without_jax(tmp_path):
    """A fresh interpreter runs the port's CPU pipeline; neither jax nor
    megahit_tpu (matched by exact package name) is ever imported."""
    code = (
        "import sys\n"
        "from megahit_tpu_torch.__main__ import main\n"
        "rc = main(['--test', '--k-list', '21', '--device', 'cpu',\n"
        "           '-o', sys.argv[1]])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'megahit_tpu'))\n"
        "print(rc, bad)\n"
        "sys.exit(0 if rc == 0 and not bad else 1)\n")
    out = tmp_path / "nojax"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (out / "final.contigs.fa").stat().st_size > 0
