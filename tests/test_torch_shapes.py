"""The flow kernels' shape range against the JAX package, on the CPU.

- **Admission, case by case.** ``should_fuse``, ``should_fuse_maf`` and
  ``fused_mutation.kernel_supports`` take what the JAX package's
  predicates (``aspire_tpu/ops/fused_coupling.py`` ``should_fuse`` and
  ``should_fuse_maf``; its chain takes every flow ``should_fuse`` takes)
  take: a CUDA float32 batch of at least ``MIN_FUSED_N`` rows, d <= 32,
  affine or RQS with up to 32 bins, weights within 8 MB, any number of
  hidden layers. The JAX predicates ask for a TPU backend, which the test
  names for them. The port refuses only the shapes no block of its forms
  holds (listed, each asserted as such).
- **Which library runs a shape**: the prebuilt library where it has the
  shape (the target id, and the depth resident), else the shape's
  instance, built at first use; nothing else (``coupling_library``,
  ``chain_library``, ``maf_library``).
- **The instance build** (``_build.build_instance``) with a stand-in
  ``nvcc``: the row it compiles, the cache key, one library however many
  threads build it at once, and a failed build raising with the
  compiler's message.
- **The packing at padded hidden widths**: (60, 60) packs bit for bit as
  (64, 64) with zero units, coupling and MAF.
- **Parity with the reference at d = 15**: the same seeded weights and
  inputs through the JAX package's ``_pallas_apply`` and
  ``_pallas_maf_forward`` (Pallas interpret mode, as
  ``tests/test_fused_coupling.py`` runs them) and the port's packed plain
  pass, float32, rtol 1e-3 / atol 1e-4 (the JAX package's own kernel
  bound).
"""

import os
import stat
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu.flows.architectures import MAF as JMAF
from aspire_tpu.flows.architectures import Coupling as JCoupling
from aspire_tpu.ops import fused_coupling as JFC
from aspire_tpu_torch.flows.architectures import (
    MAF,
    Coupling,
    maf_rqs,
    nsf,
    nsf_tpu,
    realnvp,
)
from aspire_tpu_torch.ops import _build
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import flow_params_from_jax

torch.set_num_threads(1)


class _Batch:
    """What the port's predicates read of a batch."""

    def __init__(self, n=8192, d=4, dtype=torch.float32, cuda=True):
        self.is_cuda, self.shape, self.dtype = cuda, (n, d), dtype

    def dim(self):
        return 2


def _reference(monkeypatch, jarch, n, dtype, maf=False) -> bool:
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x = jnp.zeros((n, jarch.dims), dtype)
    return (JFC.should_fuse_maf if maf else JFC.should_fuse)(jarch, x)


#: (transformer, d, hidden, bins, layers, n, float64): coupling flows the
#: port and the reference hold alike
COUPLING_CASES = [
    ("rqs", 15, (64, 64), 8, 3, 131072, False),   # the main path's shape
    ("rqs", 4, (32, 32), 8, 4, 8192, False),      # hidden widths /8
    ("rqs", 4, (60, 60), 8, 4, 8192, False),      # padded to (64, 64)
    ("rqs", 10, (64, 64), 8, 3, 8192, False),     # the funnel's default d
    ("rqs", 32, (64, 64), 8, 3, 8192, False),
    ("rqs", 2, (64, 64), 32, 3, 8192, False),     # 32 bins: the wide form
    ("rqs", 31, (96, 40), 12, 2, 8192, False),
    ("affine", 7, (48, 48), 8, 6, 8192, False),
    ("affine", 4, (64, 64), 8, 4, 4096, False),   # the smallest batch
    ("rqs", 4, (64, 64), 8, 3, 4095, False),      # refused: n < 4096
    ("rqs", 4, (64, 64), 8, 3, 8192, True),       # refused: float64
    ("rqs", 33, (64, 64), 8, 3, 8192, False),     # refused: d > 32
    ("rqs", 4, (64, 64), 33, 3, 8192, False),     # refused: 33 bins
    ("rqs", 16, (1024, 1024), 8, 4, 8192, False),  # refused: > 8 MB
]


@pytest.mark.parametrize("transformer,d,hidden,bins,layers,n,f64",
                         COUPLING_CASES)
def test_should_fuse_mirrors_the_reference(monkeypatch, transformer, d,
                                           hidden, bins, layers, n, f64):
    kw = dict(dims=d, n_layers=layers, n_hidden=hidden,
              transformer=transformer, num_bins=bins)
    ref = _reference(monkeypatch, JCoupling(**kw), n,
                     jnp.float64 if f64 else jnp.float32)
    arch = Coupling(**kw)
    batch = _Batch(n, d, torch.float64 if f64 else torch.float32)
    assert FC.should_fuse(arch, batch) == ref
    # The chain kernel takes the same flows, any in-kernel target.
    cfg = FM.ChainConfig(arch, "tpcn", 20)
    assert FM.kernel_supports(cfg) == FC.coupling_takes(arch) == (
        ref or n < FC.MIN_FUSED_N or f64)
    if FC.coupling_takes(arch):
        assert all(FM.kernel_supports(cfg, t) for t in FM.TARGET_IDS)
        assert not FM.kernel_supports(cfg, 6)
    # Never a CPU batch.
    assert not FC.should_fuse(arch, _Batch(n, d, cuda=False))


def test_what_the_port_refuses_beyond_the_reference(monkeypatch):
    """Nothing: three hidden layers are taken, as the reference takes them
    (the first on FMAs, every further product on the tensor cores), by
    B1/B3, B2 and B4; so are the shapes the older forms' blocks did not
    hold: B2 at 32 bins from d = 26 (the wide chain's state in global
    memory), a 1024-wide 1-layer coupling flow at d = 25 with 24 bins
    (B1/B3 with one resident part; B2 with its particle rows in global
    memory too)."""
    three = dict(dims=4, n_layers=3, n_hidden=(64, 64, 64),
                 transformer="rqs", num_bins=8)
    assert _reference(monkeypatch, JCoupling(**three), 8192, jnp.float32)
    assert FC.should_fuse(Coupling(**three), _Batch())
    assert FM.kernel_supports(FM.ChainConfig(Coupling(**three), "tpcn", 20))
    assert _reference(monkeypatch, JMAF(**three), 8192, jnp.float32,
                      maf=True)
    assert FC.should_fuse_maf(MAF(**three), _Batch())
    wide32 = dict(dims=26, n_layers=3, n_hidden=(64, 64), transformer="rqs",
                  num_bins=32)
    assert _reference(monkeypatch, JCoupling(**wide32), 8192, jnp.float32)
    assert FC.should_fuse(Coupling(**wide32), _Batch(d=26))
    assert FM.kernel_supports(FM.ChainConfig(Coupling(**wide32),
                                             "tpcn", 20))
    assert FM.chain_wide_plan(Coupling(**wide32))["level"] == 1
    assert FM.kernel_supports(FM.ChainConfig(
        Coupling(**dict(wide32, dims=25)), "tpcn", 20))
    big = dict(dims=25, n_layers=1, n_hidden=(1024, 1024),
               transformer="rqs", num_bins=24)
    assert _reference(monkeypatch, JCoupling(**big), 8192, jnp.float32)
    assert FC.should_fuse(Coupling(**big), _Batch(d=25))
    assert FC.mma_shape(Coupling(**big))["one_res"]
    assert FM.kernel_supports(FM.ChainConfig(Coupling(**big), "tpcn", 20))
    assert FM.chain_wide_plan(Coupling(**big))["level"] == 3


#: (d, hidden, bins, layers, n): RQS MAFs the port and the reference hold
#: alike; then affine
MAF_CASES = [
    (15, (64, 64), 8, 4, 131072),   # the streamed form
    (4, (64, 64), 8, 4, 8192),      # the prebuilt configuration
    (4, (60, 60), 8, 9, 8192),      # padded, and too deep to stay resident
    (32, (64, 64), 8, 4, 8192),
    (10, (128, 128), 32, 2, 8192),
    (4, (64, 64), 8, 4, 4095),      # refused: n < 4096
    (33, (64, 64), 8, 4, 8192),     # refused: d > 32
    (4, (64, 64), 40, 4, 8192),     # refused: 40 bins
]


@pytest.mark.parametrize("d,hidden,bins,layers,n", MAF_CASES)
def test_should_fuse_maf_mirrors_the_reference(monkeypatch, d, hidden,
                                               bins, layers, n):
    kw = dict(dims=d, n_layers=layers, n_hidden=hidden, transformer="rqs",
              num_bins=bins)
    ref = _reference(monkeypatch, JMAF(**kw), n, jnp.float32, maf=True)
    assert FC.should_fuse_maf(MAF(**kw), _Batch(n, d)) == ref
    affine = dict(kw, transformer="affine")
    assert not _reference(monkeypatch, JMAF(**affine), n, jnp.float32,
                          maf=True)
    assert not FC.should_fuse_maf(MAF(**affine), _Batch(n, d))


def test_maf_widths_the_streamed_form_does_not_hold(monkeypatch):
    """Where two dims' W3 fragments pass half a block (32 bins at d = 4
    with (192, 192): 120 KB an item, two slots), the streamed form holds
    no warp; the port takes the RQS MAF the reference takes all the same,
    in the chunked form (W3 by k-steps, level 1). W2 of any width streams
    by n-tiles, so 8 bins at that width keep the streamed form."""
    kw = dict(dims=4, n_layers=2, n_hidden=(192, 192), transformer="rqs",
              num_bins=32)
    assert _reference(monkeypatch, JMAF(**kw), 8192, jnp.float32, maf=True)
    arch = MAF(**kw)
    assert FC.should_fuse_maf(arch, _Batch())
    layout = FC.maf_stream_layout(arch)
    assert layout["level"] == 1 and layout["split3"]
    assert layout["warps"] >= 1 and layout["slot"] <= 4096
    taken = MAF(**dict(kw, num_bins=8))
    assert FC.should_fuse_maf(taken, _Batch())
    assert FC.maf_stream_layout(taken)["w2_chunks"] > 1
    assert FC.maf_stream_layout(taken)["level"] == 0


def test_the_library_each_shape_runs(monkeypatch):
    """The prebuilt library for its shapes, target ids and resident
    depths; the shape's instance for everything else, keyed by its row,
    its streamed kind where the flow's layers do not fit resident;
    ``config_id`` still the prebuilt id (of the padded widths)."""
    calls = []
    monkeypatch.setattr(FC, "load_library", lambda: "prebuilt")
    monkeypatch.setattr(FM, "load_library", lambda: "prebuilt")

    def instance(kind, row, user=None):
        calls.append((kind, row))
        return f"{kind} instance"

    monkeypatch.setattr(FC, "load_instance", instance)
    monkeypatch.setattr(FM, "load_instance", instance)
    assert FC.coupling_library(nsf_tpu(4)) == ("prebuilt", 0)
    assert FC.coupling_library(nsf(4, n_hidden=(60, 60))) == ("prebuilt", 0)
    assert FC.config_id(nsf(4, n_hidden=(60, 60))) == 0
    assert FC.coupling_library(nsf_tpu(15)) == ("coupling instance", 0)
    assert calls[-1] == ("coupling", (15, (64, 64), 8, True))
    assert FC.coupling_library(realnvp(5)) == ("coupling instance", 0)
    assert calls[-1] == ("coupling", (5, (64, 64), 1, False))

    cfg = FM.ChainConfig(nsf_tpu(4), "tpcn", 20)
    assert FM.chain_library(cfg, 1) == ("prebuilt", 0)
    assert FM.chain_library(cfg, 4) == ("chain instance", 0)
    assert calls[-1] == ("chain", (4, (64, 64), 8, True, 1))
    deep = FM.ChainConfig(nsf(4, n_layers=7), "tpcn", 20)
    assert not FM.chain_resident(deep.arch)
    assert FM.chain_library(deep, 1) == ("chain_streamed instance", 0)
    assert calls[-1] == ("chain_streamed", (4, (64, 64), 8, True, 1))
    assert FM.chain_library(FM.ChainConfig(realnvp(4), "rwmh", 5), 2) == (
        "chain instance", 0)
    assert calls[-1] == ("chain", (4, (64, 64), 1, False, 1))
    assert FM.chain_form(nsf_tpu(15)) == "wide"
    assert FM.chain_form(nsf_tpu(4)) == "whole-layer, resident"

    assert FC.maf_library(maf_rqs(4)) == ("prebuilt", 0)
    assert FC.maf_form(maf_rqs(4, n_layers=8)) == "resident"
    assert FC.maf_library(maf_rqs(4, n_layers=9)) == (
        "maf_streamed instance", 0)
    assert FC.maf_library(maf_rqs(6)) == ("maf instance", 0)
    assert FC.maf_library(maf_rqs(15)) == ("maf_streamed instance", 0)
    assert calls[-1] == ("maf_streamed", (15, (64, 64), 8))
    assert FC.maf_form(maf_rqs(15)) == "streamed"


FAKE_NVCC = """#!/bin/sh
# A stand-in nvcc: records the unit it was given, then writes the output
# file (the unit's text) or fails with a compiler-like message.
for a in "$@"; do unit="$a"; done
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
if grep -q "X(0, 7," "$unit"; then
  echo "instance_coupling.cu(3): error: a stand-in refusal" >&2
  exit 2
fi
sleep 0.2
cp "$unit" "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_build_instance_compiles_the_row_once(fake_nvcc):
    """One nvcc of a generated unit that defines the row (id 0) and
    includes the kind's source, into the cache beside its log; threads
    building it at once leave one library and no temporary files; another
    row, kind or user source is another library."""
    row = FC.coupling_row(nsf_tpu(15))
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(
        _build.build_instance("coupling", row))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    path = _build.instance_path("coupling", row)
    assert set(paths) == {path} and path.parent == fake_nvcc
    unit = path.read_text()
    assert ("#define ASPIRE_INSTANCE_CONFIG(X) X(0, 15, (64, 64), 8, true)"
            in unit)
    assert f'#include "{_build.CSRC / "coupling.cu"}"' in unit
    assert path.with_suffix(".log").exists()
    assert sorted(p.name for p in fake_nvcc.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])
    others = {_build.instance_path("coupling", FC.coupling_row(nsf_tpu(16))),
              _build.instance_path("chain", FM.chain_row(nsf_tpu(15))),
              _build.instance_path("maf", FC.maf_row(maf_rqs(15)))}
    assert path not in others and len(others) == 3
    # Nothing is built again once the library is there.
    mtime = os.stat(path).st_mtime_ns
    assert _build.build_instance("coupling", row) == path
    assert os.stat(path).st_mtime_ns == mtime


def test_instance_rows_name_the_depth(fake_nvcc):
    """An instance's row names every hidden width (padded), so flows of
    two depths never share a library; a user target's chain instance
    (``_build.build_user``) takes the depth's row too."""
    from aspire_tpu_torch.models.targets import KernelSource

    rows = [FC.coupling_row(nsf_tpu(4, n_hidden=h))
            for h in ((128,), (64, 64), (64, 64, 64), (60, 60, 60), ())]
    assert rows[3] == rows[2] == (4, (64, 64, 64), 8, True)
    paths = {_build.instance_path("coupling", r) for r in rows}
    assert len(paths) == 4
    unit = _build.build_instance("coupling", rows[2]).read_text()
    assert "X(0, 4, (64, 64, 64), 8, true)" in unit
    assert "X(0, 4, (), 8, true)" in _build.build_instance(
        "coupling", rows[4]).read_text()
    source = KernelSource("depth_probe", "// a stand-in source\n")
    row = FM.chain_row(nsf_tpu(4, n_hidden=(128,)))
    path = _build.build_user(source, row)
    assert path == _build.user_library_path(source, row)
    assert "X(0, 4, (128), 8, true, 1)" in path.read_text()


def test_failed_instance_build_raises_with_nvcc_message(fake_nvcc):
    row = FC.coupling_row(nsf_tpu(7))
    with pytest.raises(RuntimeError,
                       match="(?s)nvcc failed.*stand-in refusal"):
        _build.build_instance("coupling", row)
    path = _build.instance_path("coupling", row)
    assert not path.exists()
    assert "stand-in refusal" in path.with_suffix(".log").read_text()


def _padded(params, hidden):
    """``params`` with zero units appended to each hidden layer."""
    pad = torch.nn.functional.pad
    out = []
    for net in params["layers"]:
        l1, l2, l3 = net["layers"]
        p1 = hidden[0] - l1["w"].shape[1]
        p2 = hidden[1] - l2["w"].shape[1]
        out.append({"layers": [
            {"w": pad(l1["w"], (0, p1)), "b": pad(l1["b"], (0, p1))},
            {"w": pad(l2["w"], (0, p2, 0, p1)), "b": pad(l2["b"], (0, p2))},
            {"w": pad(l3["w"], (0, 0, 0, p2)), "b": l3["b"]}]})
    return {"layers": out}


def _perturbed(arch, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = arch.init(gen)
    for net in params["layers"]:
        for layer in net["layers"]:
            for k in ("w", "b"):
                layer[k] = layer[k] + 0.1 * torch.randn(layer[k].shape,
                                                        generator=gen)
    return params


@pytest.mark.parametrize("d", [4, 15])
def test_padded_hidden_widths_pack_as_zero_units(d):
    """A (60, 60) coupling flow packs bit for bit as the (64, 64) flow
    whose extra units have zero weights (the whole-layer form at d = 4,
    the wide one at d = 15); its plain pass is that flow's."""
    arch = nsf_tpu(d, n_hidden=(60, 60))
    params = _perturbed(arch, d)
    wide = _padded(params, (64, 64))
    assert torch.equal(FC.prepare_mma_params(arch, params),
                       FC.prepare_mma_params(nsf_tpu(d), wide))
    x = torch.randn(64, d)
    for a, b in zip(arch.forward_plain(params, x),
                    nsf_tpu(d).forward_plain(wide, x)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_padded_hidden_widths_pack_as_zero_units_maf():
    """The same for an RQS MAF (the padded units' MADE degrees those of
    the wider layer, their weights zero)."""
    arch = maf_rqs(6, n_hidden=(60, 60), n_layers=2)
    params = _perturbed(arch, 6)
    wide = _padded(params, (64, 64))
    assert torch.equal(FC.prepare_maf_params(arch, params),
                       FC.prepare_maf_params(maf_rqs(6, n_layers=2), wide))


def _jax_pair(cls, tcls, **kw):
    jarch = cls(dtype="float32", **kw)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(1), p.shape,
                                               p.dtype), params)
    return jarch, params, tcls(dtype="float32", **kw), flow_params_from_jax(
        params, dtype="float32")


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_d15_packed_plain_matches_jax_pallas_interpret(mode):
    """nsf-tpu's widths at d = 15, hidden (60, 60) (padded by the port):
    the port's packing, read as the wide form reads it, against the JAX
    Pallas kernel in interpret mode."""
    jarch, params, tarch, tparams = _jax_pair(
        JCoupling, Coupling, dims=15, n_layers=3, n_hidden=(60, 60),
        transformer="rqs", num_bins=8)
    x = np.random.default_rng(15).normal(size=(256, 15)).astype(np.float32)
    yj, ldj = JFC._pallas_apply(jarch, mode, JFC.prepare_params(jarch, params),
                                jnp.asarray(x), interpret=True)
    assert FC.mma_wide(tarch)
    yt, ldt = FC.coupling_packed_plain(
        tarch, mode, FC.prepare_mma_params(tarch, tparams),
        torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)


def test_d15_maf_packed_plain_matches_jax_pallas_interpret():
    """maf-rqs at d = 15 ((64, 64), 8 bins, 2 layers): the port's packing
    read as the kernel reads it against the JAX Pallas MAF kernel in
    interpret mode."""
    jarch, params, tarch, tparams = _jax_pair(
        JMAF, MAF, dims=15, n_layers=2, n_hidden=(64, 64),
        transformer="rqs", num_bins=8)
    x = (1.5 * np.random.default_rng(16).normal(size=(256, 15))).astype(
        np.float32)
    zj, ldj = JFC._pallas_maf_forward(
        jarch, JFC.prepare_maf_params(jarch, params), jnp.asarray(x),
        interpret=True)
    z, ld = FC.maf_packed_plain(tarch, FC.prepare_maf_params(tarch, tparams),
                                torch.as_tensor(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)
