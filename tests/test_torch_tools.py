"""The port's toolkit (megahit_tpu_torch.tools) against megahit_tpu's.

The same seeded inputs go through both packages' contig2fastg,
filterbylen and readstat, and through both tools' `main` in a child
process each (stdin and stdout as a user has them); every output must
be byte-identical. Tolerance: exact equality."""

import gzip
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from megahit_tpu import tools as jtools
from megahit_tpu.core import packing
from megahit_tpu_torch import tools as ttools

import torch_test_env  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Contigs with k-overlaps in both orientations, one too short for
    k, lower-case and N bases, headers with and without multi=; reads as
    FASTA, FASTQ and gzip FASTA."""
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(13)
    k = 21
    g = rng.integers(0, 4, size=900).astype(np.uint8)
    a = packing.decode(g[:150])
    b = packing.decode(g[150 - k:280])  # starts with a's last k bases
    c = packing.decode(packing.revcomp_codes(g[260:420]))  # rc overlap
    e = packing.decode(g[500:512])  # shorter than k + 1
    f = packing.decode(g[600:900]).lower()[:100] + "NNAC" + \
        packing.decode(g[700:800])
    contigs = d / "k21.contigs.fa"
    contigs.write_text(
        f">k21_0 flag=0 multi=3.5 len={len(a)}\n{a[:70]}\n{a[70:]}\n"
        f">k21_1 flag=1 multi=2.0 len={len(b)}\n{b}\n"
        f">k21_2 flag=0 multi=11.25 len={len(c)}\n{c}\n"
        f">k21_3 flag=0 multi=1.0 len={len(e)}\n{e}\n"
        f">contig_without_multi\n{f}\n\n")
    fa = d / "r.fa"
    fa.write_text(">x desc\nACGT\n>y\nACGTACGT\nAC\n>z\n\n>w\nNNACGTNN\n")
    fq = d / "r.fq"
    fq.write_text("@q1\nACGTAC\n+\nIIIIII\n@q2 two\nAC\n+\nII\n")
    gz = d / "r.fa.gz"
    with gzip.open(gz, "wt") as fh:
        for i in range(50):
            L = int(rng.integers(1, 150))
            fh.write(f">s{i}\n{packing.decode(rng.integers(0, 4, L))}\n")
    return {"contigs": str(contigs), "reads": [str(fa), str(fq), str(gz)],
            "fasta": str(fa)}


@pytest.mark.parametrize("k", [21, 31])
def test_contig2fastg(inputs, k):
    want, got = io.StringIO(), io.StringIO()
    jtools.contig2fastg(k, inputs["contigs"], out=want)
    ttools.contig2fastg(k, inputs["contigs"], out=got)
    assert got.getvalue() == want.getvalue()
    if k == 21:
        # a links to b, and a's reverse complement is linked into
        assert "NODE_1_length_150_cov_3.5000_ID_1:NODE_2_" in got.getvalue()


@pytest.mark.parametrize("min_len", [0, 120, 10_000])
def test_filterbylen(inputs, min_len):
    text = pathlib.Path(inputs["contigs"]).read_text()
    outs = []
    for mod in (jtools, ttools):
        out, err = io.StringIO(), io.StringIO()
        mod.filterbylen(min_len, inp=io.StringIO(text), out=out, err=err)
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[1] == outs[0]
    assert ("0 contigs" in outs[1][1]) == (min_len == 10_000)


def test_readstat(inputs):
    for paths in ([inputs["fasta"]], inputs["reads"]):
        want, got = io.StringIO(), io.StringIO()
        jtools.readstat(paths, out=want)
        ttools.readstat(paths, out=got)
        assert got.getvalue() == want.getvalue()
    assert "number reads: 56" in got.getvalue()


# runs one tools `main` per line of argv lists, each with its own stdin
# file, and prints one JSON record per call: megahit_tpu binds its
# streams as default arguments when its module runs, so the module is
# reloaded under each call's streams
_DRIVER = """
import importlib, io, json, sys
tools = importlib.import_module(sys.argv[1] + ".tools")
res = []
for argv, stdin in json.loads(sys.argv[2]):
    out, err = io.StringIO(), io.StringIO()
    sys.stdin = open(stdin) if stdin else io.StringIO("")
    sys.stdout, sys.stderr = out, err
    importlib.reload(tools)
    rc = tools.main(argv)
    sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
    res.append([rc, out.getvalue(), err.getvalue()])
print(json.dumps(res))
"""


def test_tools_main_matches(inputs):
    calls = [
        (["dumpversion"], None), (["version"], None), (["kmax"], None),
        (["contig2fastg", "21", inputs["contigs"]], None),
        (["contig2fastg", "21"], None),
        (["filterbylen", "100"], inputs["contigs"]),
        (["filterbylen"], inputs["contigs"]),
        (["readstat"] + inputs["reads"], None),
        (["readstat"], inputs["fasta"]),
        (["nope"], None),
    ]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = {}
    for pkg in ("megahit_tpu", "megahit_tpu_torch"):
        r = subprocess.run(
            [sys.executable, "-c", _DRIVER, pkg, json.dumps(calls)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        res[pkg] = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["megahit_tpu_torch"] == res["megahit_tpu"]
    rcs = [rc for rc, _, _ in res["megahit_tpu_torch"]]
    assert rcs == [0, 0, 0, 0, 1, 0, 0, 0, 0, 1]


def test_tools_main_usage_and_checkcpu(capsys):
    assert ttools.main([]) == 1
    assert "megahit_tpu_torch.tools" in capsys.readouterr().err
    assert ttools.main(["checkcpu"]) == 0
    out = capsys.readouterr().out
    assert f"host cpus: {os.cpu_count()}" in out and "torch: " in out
