"""Which teardown of a one-rank NCCL group ends after the mesh ladder's
rung was captured (ROADMAP C19).

The parent fits the main path's flow (``chip_smoke.mesh_aspire``) once;
then each variant runs in a child process of its own, joined with a
deadline: the child joins a one-rank NCCL group, runs the device ladder on
the mesh twice per resampling impl (``chip_smoke.mesh_pipeline`` at
n = 16384: a capture, then replays), and then

- ``release``: drops the cached ladders (their graphs) and collects, then
  ``destroy_process_group()``;
- ``auto_only``: runs only the gather's ladder (no all-to-all captured)
  and destroys the group with its graph alive;
- ``keep``: destroys the group with the all-to-all's graph alive (a
  plain ``destroy_process_group()``, which releases the mesh's captured
  ladders first: ``mesh.track_captured``);
- ``exit``: exits without destroying the group.

Each variant's exit code, seconds and the seconds ``destroy`` took are
printed; a child that hangs dumps its Python stack and ends. From the
repository root, on the machine with the card (all variants, or those
named):

    python3 tools/mesh_teardown_probe.py [VARIANT ...]
"""

import faulthandler
import gc
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

VARIANTS = ("release", "auto_only", "keep", "exit")
#: seconds before a child dumps its stack and ends, and the parent's wait
HANG_S, WAIT_S = 100, 130


def child(variant: str, folder: str) -> None:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from aspire_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    initialize_distributed(num_processes=1, process_id=0, backend="nccl",
                           init_method=f"file://{folder}/rdv_{variant}")
    mesh = make_mesh()
    state = torch.load(f"{folder}/flow.pt", map_location=mesh.device,
                       weights_only=False)
    _, asp = cs.mesh_aspire(mesh.device, state)
    impls = ("auto",) if variant == "auto_only" else cs.MESH_IMPLS
    for impl in impls:
        for _ in range(2):
            run = cs.mesh_pipeline(asp, cs.N_PIPELINE // 8, mesh, impl,
                                   ladder=True)
        print(variant, impl, run["mode"], run["replays"], flush=True)
    if variant == "release":
        asp.ladder_cache.clear()
        del asp, run
        gc.collect()
        torch.cuda.synchronize()
    if variant == "exit":
        print("exiting without destroy", flush=True)
        return
    t = time.time()
    dist.destroy_process_group()
    print(variant, "destroyed in", time.time() - t, flush=True)


def main(variants) -> None:
    import torch

    import chip_smoke as cs
    from aspire_tpu_torch.ops import _build

    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load_library()
    _, asp = cs.mesh_aspire(torch.device("cuda"))
    folder = tempfile.mkdtemp()
    torch.save((asp.flow.params, asp.flow.data_transform),
               f"{folder}/flow.pt")
    for variant in variants:
        t = time.time()
        try:
            r = subprocess.run([sys.executable, __file__, variant, folder],
                               timeout=WAIT_S, capture_output=True,
                               text=True)
            print(variant, "rc", r.returncode, round(time.time() - t, 1),
                  r.stdout[-800:], r.stderr[-1500:], flush=True)
        except subprocess.TimeoutExpired as err:
            print(variant, "timed out", err.stdout, err.stderr, flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in VARIANTS and Path(
            sys.argv[2]).is_dir():
        child(sys.argv[1], sys.argv[2])
    else:
        main(sys.argv[1:] or VARIANTS)
