"""The flow kernels' corner forms, run on the CPU under the stand-in runtime.

The forms a flow takes where the older ones leave no room in a block
(ROADMAP B9 item 1), each compiled as its instance is built at first use
(``ops/_build.py::build_instance``: the row defined, the source included)
under the stand-in CUDA runtime of ``tests/test_torch_shapes_emulated.py``
and held against the plain pass at the card check's tolerances, at the
narrowest corner of the scan grid that selects it:

- B1/B3 with one resident part (``MmaShape::ONE_RES``: two leave no warp
  beside the chunks): nsf at d = 29, one layer of (1024, 1024), 20 bins,
  both modes, one warp;
- B2's wide block at each level of ``ChainWidePlan``
  (``FM.chain_wide_plan``): 1, the chain state in global memory (d = 29,
  (16,), 28 bins), 2, also one resident part (d = 27, (384,), 32 bins), 3,
  also the particle rows in global memory (d = 30, (768,), 32 bins), one
  tile, one layer, on injected noise;
- B4's chunked form (``MafChunked``) at level 1, W3 by k-steps (d = 6,
  (192,), 28 bins), and level 2, W1 streamed too (d = 31, (768,), 2
  bins), 2 layers, 5 tiles the last ragged;
- each instance's tables (layout, the chain's block plan, the MAF's
  streamed block) against the Python mirror.

Skips where no ``g++`` with C++20 is installed on x86-64.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu_torch.flows.architectures import MAF, Coupling
from aspire_tpu_torch.ops import _build
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from test_torch_chain_emulated import CHAIN_RUNTIME
from test_torch_maf_emulated import (
    CSRC,
    RUNTIME,
    cxx20_compiler,
    emulated_source,
)
from test_torch_shapes_emulated import (
    CHAIN,
    COUPLING,
    MAF as MAF_HARNESS,
    ROW,
    _chain,
    _chain_plan,
    _coupling,
    _lines,
)


def _nsf(d, hidden, bins, layers=1):
    return Coupling(dims=d, n_layers=layers, n_hidden=hidden,
                    transformer="rqs", num_bins=bins)


def _maf(d, hidden, bins, layers=2):
    return MAF(dims=d, n_layers=layers, n_hidden=hidden, transformer="rqs",
               num_bins=bins)


#: name -> (kind, harness, flow, the level or form it takes)
CORNERS = {
    "one_res": ("coupling", COUPLING, _nsf(29, (1024, 1024), 20), None),
    "chain1": ("chain", CHAIN, _nsf(29, (16,), 28), 1),
    "chain2": ("chain", CHAIN, _nsf(27, (384,), 32), 2),
    "chain3": ("chain", CHAIN, _nsf(30, (768,), 32), 3),
    "maf1": ("maf_streamed", MAF_HARNESS, _maf(6, (192,), 28), 1),
    "maf2": ("maf_streamed", MAF_HARNESS, _maf(31, (768,), 2), 2),
}


def _row(kind, arch):
    return (FM.chain_row(arch) if kind == "chain" else
            FC.maf_row(arch) if kind.startswith("maf") else
            FC.coupling_row(arch))


@pytest.fixture(scope="module")
def corners(tmp_path_factory):
    root = tmp_path_factory.mktemp("corners_emulated")
    gxx = cxx20_compiler(root)
    procs = {}
    for name, (kind, harness, arch, _) in CORNERS.items():
        row = _row(kind, arch)
        sub = root / name
        sub.mkdir()
        (sub / "cuda_runtime.h").write_text(RUNTIME + CHAIN_RUNTIME)
        shutil.copy(CSRC / "common.cuh", sub / "common.cuh")
        (sub / "instance.cpp").write_text(
            ("#define ASPIRE_STREAMED 1\n" if kind.endswith("_streamed")
             else "")
            + f"#define ASPIRE_INSTANCE_CONFIG(X) {_build.instance_row(row)}\n"
            + emulated_source(_build.INSTANCE_SOURCES[kind]))
        (sub / "harness.cpp").write_text(harness)
        values = [("true" if v else "false") if isinstance(v, bool) else
                  "aspire::Hidden<" + ",".join(map(str, v)) + ">"
                  if isinstance(v, tuple) else str(v) for v in row]
        defines = [f"-D{k}={v}" for k, v in zip(ROW.split(", "), values)]
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-w", *defines, f"-I{sub}", "-o",
             str(root / f"run_{name}"), str(sub / "harness.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, f"{name}: {out[-4000:]}"
    return root


def test_corners_take_the_new_forms():
    """Each corner is one the older forms leave no room for, and takes the
    form named: B1/B3 one resident part with warps beside it, B2 the level
    of its block, B4 the chunked form's level."""
    arch = CORNERS["one_res"][2]
    shape = FC.mma_shape(arch)
    assert shape["wide"] and shape["one_res"] and shape["warps"] >= 1
    assert 2 * (shape["res"] + shape["chunk"]) + shape["stage"] > (
        FC.MAX_SHARED_BYTES // 4)
    for name in ("chain1", "chain2", "chain3"):
        arch, level = CORNERS[name][2], CORNERS[name][3]
        assert FC.mma_wide(arch)
        assert FM.chain_wide_plan(arch)["level"] == level
        assert FM.chain_shared_bytes(
            arch, FM.consts_layout(arch.dims)[-1]) <= FC.MAX_SHARED_BYTES
    for name in ("maf1", "maf2"):
        arch, level = CORNERS[name][2], CORNERS[name][3]
        layout = FC.maf_stream_layout(arch)
        assert FC.maf_form(arch) == "streamed"
        assert layout["level"] == level and layout["warps"] >= 1


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_one_resident_part_matches_plain(corners, mode):
    """B1 (density) and B3 (sampling) with one resident part, one layer of
    (1024, 1024) at d = 29, one warp of 32 particles: its layout table
    against the Python packing, then the pass against the plain one (card
    tolerance, float64 arbitration) and the packed reader."""
    arch = CORNERS["one_res"][2]
    table, (wide,) = _lines(corners / "run_one_res")
    assert table == [*FC.mma_layout(arch), FC.coupling_warps(arch)]
    assert wide == 1
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), 7, arch,
                                             0.05)
    x = torch.as_tensor(np.random.default_rng(29).normal(
        size=(32, arch.dims)).astype(np.float32))
    packed, y, ld = _coupling(corners, "one_res", arch, params, mode, x, 1)
    plain = arch.forward_plain if mode == "forward" else arch.inverse_plain
    y_p, ld_p = plain(params, x)
    y_e, ld_e = plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(y, y_p, y_e, f"emulated one_res {mode} y")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e,
                                   f"emulated one_res {mode} log_det")
    y_r, ld_r = FC.coupling_packed_plain(arch, mode, packed, x)
    torch.testing.assert_close(y, y_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)


@pytest.mark.parametrize("name", ["chain1", "chain2", "chain3"])
def test_wide_chain_levels_match_plain(corners, name):
    """B2's wide chain at each level of its block: the layout table,
    constant block and block plan against the Python mirror, then one tile,
    one tpCN step of a one-layer flow on the mixture with the affine data
    transform, on injected noise, against the plain chain at the card
    check's tolerances."""
    arch = CORNERS[name][2]
    table, consts, plan = _lines(corners / f"run_{name}")
    assert table == list(FM.chain_layout(arch))
    assert consts == list(FM.consts_layout(arch.dims))
    assert plan == _chain_plan(arch) and plan[0] == CORNERS[name][3]
    _chain(corners, name, chip_smoke.shapes_chain_setup(
        torch.device("cpu"), FM.TILE, 1, arch))


@pytest.mark.parametrize("name", ["maf1", "maf2"])
def test_chunked_maf_matches_plain(corners, name):
    """B4's chunked form, W3 by k-steps (level 1) and W1 streamed too
    (level 2): its layout and streamed block against the Python mirror,
    then 2 layers on 5 tiles (the last ragged) over 2 blocks of 2 warps
    against the plain pass (card tolerance, float64 arbitration) and the
    packed reader."""
    arch, level = CORNERS[name][2], CORNERS[name][3]
    (layer, stage, *ksteps), block = _lines(corners / f"run_{name}")
    assert [layer, stage, *ksteps] == [FC.maf_layer_floats(arch),
                                       FC.maf_stage_floats(arch),
                                       *sum(FC.maf_ksteps(arch), ())]
    layout = FC.maf_stream_layout(arch)
    assert block == [layout[k] for k in ("slot", "head", "w2_chunks",
                                         "stage", "bufs", "level")]
    assert layout["level"] == level
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), 9, arch,
                                             0.05)
    d, n = arch.dims, 4 * 16 + 7
    x = 2.0 * torch.as_tensor(np.random.default_rng(n).normal(
        size=(n, d)).astype(np.float32))
    packed = FC.prepare_maf_params(arch, params)
    inp, out = corners / f"in_{name}.bin", corners / f"out_{name}.bin"
    np.concatenate([x.numpy().ravel(), packed.numpy()]).tofile(inp)
    subprocess.run([str(corners / f"run_{name}"), str(n),
                    str(arch.n_layers), "2", "2", str(inp), str(out)],
                   check=True, timeout=600)
    res = torch.as_tensor(np.fromfile(out, dtype=np.float32))
    z, ld = res[:d * n].reshape(n, d), res[d * n:]
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(chip_smoke.as_float64(params), x.double())
    chip_smoke.assert_kernel_close(z, z_p, z_e, f"emulated {name} z")
    chip_smoke.assert_kernel_close(ld, ld_p, ld_e, f"emulated {name} log_det")
    z_r, ld_r = FC.maf_packed_plain(arch, packed, x)
    torch.testing.assert_close(z, z_r, **chip_smoke.COUPLING_TOL)
    torch.testing.assert_close(ld, ld_r, **chip_smoke.COUPLING_TOL)
