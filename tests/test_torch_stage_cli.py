"""The port's stage subcommands against megahit_tpu's.

The same seeded read sets go through both stage CLIs (megahit_tpu on
the JAX CPU backend, the port with --device cpu) stage by stage, each
package in its own directory. Every artifact must be equal: text files
(FASTA, .info, .counting) byte for byte, .npz files array by array
(names, dtypes, shapes, values; the zip members carry timestamps, so
the files' bytes are not compared). Tolerance: exact equality."""

import gzip
import os
import pathlib

import numpy as np
import pytest
import torch

from megahit_tpu.core import packing
from megahit_tpu.stage_cli import main as jstage
from megahit_tpu_torch import __version__
from megahit_tpu_torch.graph.sdbg import Sdbg
from megahit_tpu_torch.io.contig_io import read_contigs
from megahit_tpu_torch.stage_cli import main as tstage

from torch_test_env import assert_same_files


def _toy_pairs(d: pathlib.Path) -> list[str]:
    """megahit_tpu's tests/test_stage_cli.py input: a 3 kbp genome,
    error-free 2x100 bp pairs (insert 250) every 2 bp."""
    rng = np.random.default_rng(4242)
    genome = rng.integers(0, 4, size=3000).astype(np.uint8)
    p1, p2 = str(d / "r1.fa.gz"), str(d / "r2.fa.gz")
    with gzip.open(p1, "wt") as f1, gzip.open(p2, "wt") as f2:
        for i, s in enumerate(range(0, len(genome) - 250 + 1, 2)):
            frag = genome[s: s + 250]
            f1.write(f">x{i}/1\n{packing.decode(frag[:100])}\n")
            f2.write(f">x{i}/2\n"
                     f"{packing.decode(packing.revcomp_codes(frag[-100:]))}"
                     "\n")
    return ["-1", p1, "-2", p2]


def _repeat_pairs(d: pathlib.Path) -> list[str]:
    """A 9 kbp genome with a 30-bp repeat, 2x100 bp pairs every 3 bp with
    1% substitutions: the k=21 graph breaks at the repeat and has error
    tips, so local assembly and iterate have work to do."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=9000).astype(np.uint8)
    genome[6000:6030] = genome[2000:2030]
    p1, p2 = str(d / "r1.fa.gz"), str(d / "r2.fa.gz")
    with gzip.open(p1, "wt") as f1, gzip.open(p2, "wt") as f2:
        for i, s in enumerate(range(0, len(genome) - 250, 3)):
            frag = genome[s: s + 250].copy()
            m = rng.random(250) < 0.01
            frag[m] = (frag[m] + rng.integers(1, 4, int(m.sum()))) % 4
            f1.write(f">r{i}/1\n{packing.decode(frag[:100])}\n")
            f2.write(f">r{i}/2\n"
                     f"{packing.decode(packing.revcomp_codes(frag[-100:]))}"
                     "\n")
    return ["-1", p1, "-2", p2]


def _chain(stage, d: str, reads: list[str], dev: list[str]) -> None:
    """megahit_tpu's test_manual_stage_chain, stage by stage; `dev` goes
    before the subcommand for some stages and after it for others."""
    def p(name):
        return os.path.join(d, name)

    lib = p("lib.npz")
    assert stage(["buildlib"] + reads + ["-o", lib]) == 0
    assert stage(dev + ["count", "--lib", lib, "-k", "21", "-m", "2",
                        "-o", p("k21")]) == 0
    assert stage(["seq2sdbg", "--edges", p("k21.edges.npz"), "--need-mercy",
                  "--lib", lib, "-k", "21",
                  "-o", p("k21.sdbg.npz")] + dev) == 0
    assert stage(dev + ["assemble", "-s", p("k21.sdbg.npz"), "-o", p("k21"),
                        "--careful-bubble"]) == 0
    assert stage(["local", "-c", p("k21.contigs.fa"), "--lib", lib,
                  "--kmax", "41", "-o", p("k21.local.fa")] + dev) == 0
    assert stage(dev + ["iterate", "-c", p("k21.contigs.fa"),
                        "-b", p("k21.bubble_seq.fa"), "--lib", lib,
                        "-k", "21", "-s", "20", "-o", p("k41")]) == 0
    assert stage(dev + ["seq2sdbg", "--edges", p("k41.edges.npz"),
                        "--contig", p("k21.contigs.fa"),
                        "--local-contig", p("k21.local.fa"),
                        "-k", "41", "--kmer-from", "21",
                        "-o", p("k41.sdbg.npz")]) == 0
    assert stage(dev + ["assemble", "-s", p("k41.sdbg.npz"), "-o", p("k41"),
                        "--is-final-round", "--output-standalone"]) == 0


@pytest.fixture(scope="module", params=["toy", "repeat"])
def chains(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"chain_{request.param}")
    reads = (_toy_pairs if request.param == "toy" else _repeat_pairs)(d)
    j, t = d / "jax", d / "torch"
    j.mkdir()
    t.mkdir()
    _chain(jstage, str(j), reads, [])
    _chain(tstage, str(t), reads, ["--device", "cpu"])
    return request.param, j, t


def test_stage_chain_artifacts_equal(chains):
    name, j, t = chains
    names = assert_same_files(j, t)
    assert "k21.counting" in names and "k41.sdbg.npz" in names
    # the chain assembles: megahit_tpu's own check on its toy input
    finals = read_contigs(str(t / "k41.contigs.fa")) + \
        read_contigs(str(t / "k41.final.contigs.fa"))
    assert max(c.length for c in finals) > (2900 if name == "toy" else 2000)
    if name == "repeat":
        # local assembly and iterate ran on real work
        assert read_contigs(str(t / "k21.local.fa"))
        assert len(np.load(t / "k41.edges.npz")["keys"])


def test_graphs_interoperate(chains):
    """Each package loads the other's SdBG file to the same graph."""
    from megahit_tpu.graph.sdbg import Sdbg as JSdbg

    _, j, t = chains
    for name in ("k21.sdbg.npz", "k41.sdbg.npz"):
        a = Sdbg.load(str(j / name), device="cpu")
        b = JSdbg.load(str(t / name))
        assert a.k == b.k and a.real == b.real
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.mult, b.mult)
        np.testing.assert_array_equal(a.valid, b.valid)


@pytest.fixture(scope="module")
def single_end(tmp_path_factory):
    """megahit_tpu's read2sdbg input: 80 bp reads every 3 bp of a 2 kbp
    genome, counted by each package's count stage."""
    d = tmp_path_factory.mktemp("r2s")
    rng = np.random.default_rng(4243)
    genome = rng.integers(0, 4, size=2000).astype(np.uint8)
    reads = d / "r.fa"
    with open(reads, "w") as fh:
        for i, s in enumerate(range(0, len(genome) - 80, 3)):
            fh.write(f">r{i}\n{packing.decode(genome[s:s + 80])}\n")
    lib = str(d / "lib.npz")
    assert tstage(["buildlib", "-r", str(reads), "-o", lib]) == 0
    assert tstage(["--device", "cpu", "count", "--lib", lib, "-k", "21",
                   "-m", "2", "-o", str(d / "k21")]) == 0
    return d, lib


@pytest.mark.parametrize("mercy", [False, True])
def test_read2sdbg_matches_two_pass(single_end, mercy, capsys):
    """1-pass read2sdbg == count + seq2sdbg (same valid edges, same
    multiplicities) at --memory 1e6, which forces several spill rounds;
    and the port's read2sdbg file equals megahit_tpu's."""
    d, lib = single_end
    two = ["--device", "cpu", "seq2sdbg", "--edges", str(d / "k21.edges.npz"),
           "-k", "21", "-o", str(d / "a.sdbg.npz")]
    one = ["read2sdbg", "--lib", lib, "-k", "21", "-m", "2", "--memory",
           "1e6"] + (["--need-mercy"] if mercy else [])
    if mercy:
        two += ["--need-mercy", "--lib", lib]
    assert tstage(two) == 0
    capsys.readouterr()
    assert tstage(one + ["--device", "cpu", "-o", str(d / "b.sdbg.npz")]) == 0
    rounds = int(capsys.readouterr().out.split(" rounds)")[0].split()[-1])
    assert rounds > 1
    assert jstage(one + ["-o", str(d / "c.sdbg.npz")]) == 0
    a = Sdbg.load(str(d / "a.sdbg.npz"), device="cpu")
    b = Sdbg.load(str(d / "b.sdbg.npz"), device="cpu")
    np.testing.assert_array_equal(a.keys[a.valid], b.keys[b.valid])
    np.testing.assert_array_equal(a.mult[a.valid], b.mult[b.valid])
    zb, zc = np.load(d / "b.sdbg.npz"), np.load(d / "c.sdbg.npz")
    assert sorted(zb.files) == sorted(zc.files)
    for f in zb.files:
        assert zb[f].dtype == zc[f].dtype
        np.testing.assert_array_equal(zb[f], zc[f], f)


@pytest.mark.parametrize("cmd", ["dumpversion", "kmax"])
def test_introspection_matches(cmd, capsys):
    assert jstage([cmd]) == 0
    want = capsys.readouterr().out
    assert tstage([cmd]) == 0
    assert capsys.readouterr().out == want
    assert want.strip() == {"dumpversion": __version__, "kmax": "255"}[cmd]


def test_checkcpu_and_checknative(capsys):
    """Without a card the CUDA probe reports 0 (and checkcpu still exits
    0); the native host cores built in this checkout report 1."""
    if torch.cuda.is_available():
        pytest.skip("checks the report of a machine without a CUDA device")
    from megahit_tpu_torch import stage_cli

    assert tstage(["checkcpu", "--deadline", "60"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "0"
    for alias in ("checkpopcnt", "checkbmi2"):
        args = stage_cli.make_parser().parse_args([alias])
        assert args.fn is stage_cli.cmd_checkcpu
    assert tstage(["checknative"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "1"


@pytest.mark.parametrize("argv", [
    ["count", "--lib", "x.npz", "-k", "21", "-o", "x"],
    ["read2sdbg", "--lib", "x.npz", "-k", "21", "-o", "x"],
    ["seq2sdbg", "--edges", "x.npz", "-k", "21", "-o", "x"],
    ["assemble", "-s", "x.npz", "-o", "x"],
    ["local", "-c", "x.fa", "--lib", "x.npz", "-o", "x"],
    ["iterate", "-c", "x.fa", "--lib", "x.npz", "-k", "21", "-s", "20",
     "-o", "x"],
], ids=lambda a: a[0])
def test_device_stage_needs_cuda(argv):
    """cuda is the default: a device stage without --device cpu stops at
    once when there is no card, before it reads its inputs."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstage(argv)
