"""Runs ``chip_smoke.py``'s device-plane mesh phases alone on the card.

Builds the kernels, then runs ``dplane_adam_lockstep`` (whose runs the
replicated phase is held against), ``dplane_mesh_adam_replicated``,
``dplane_mesh_sync_sharded`` and ``dplane_mesh_migrate``, each printing its
K3 count, its GRAD round trip against the one-rank plane and its checks, as
the whole script does, without the other phases' load beside them.  Prints
each phase's seconds last; exits non-zero if a phase fails.

    python tools/torch_dplane_mesh_phases.py
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mpit_tpu_torch import obs  # noqa: E402
from mpit_tpu_torch.data.mnist import load_mnist  # noqa: E402
from mpit_tpu_torch.ops import build  # noqa: E402
from mpit_tpu_torch.ops.flash_attention import (flash_bwd_fused,  # noqa: E402
                                                flash_bwd_two_kernel, flash_fwd)
from mpit_tpu_torch.ops.fused_update import (fused_adam, fused_elastic,  # noqa: E402
                                             fused_nesterov_commit)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    print("device:", smi, torch.__version__, torch.version.cuda, flush=True)
    print("build", build.build_all(), flush=True)
    kernels = {"k1": fused_nesterov_commit, "k2": fused_elastic, "k3": fused_adam,
               "k4": flash_fwd, "k5": flash_bwd_fused, "k6": flash_bwd_two_kernel}
    all_paths = {k: {} for k in kernels}
    obs.configure(enabled=False)
    raw, _ = load_mnist(side=cs.GANG_BASE["side"])
    data = (torch.as_tensor(raw[0], device="cuda"),
            torch.as_tensor(np.asarray(raw[1]), dtype=torch.int64, device="cuda"))
    seconds = {}
    torch.backends.cudnn.deterministic = True
    t = time.perf_counter()
    runs = cs.dplane_adam_lockstep(torch, kernels, data, all_paths, smi)
    seconds["lockstep"] = time.perf_counter() - t
    t = time.perf_counter()
    cs.dplane_mesh_adam_replicated(torch, kernels, data, all_paths, smi, runs)
    seconds["replicated"] = time.perf_counter() - t
    torch.backends.cudnn.deterministic = False
    t = time.perf_counter()
    cs.dplane_mesh_sync_sharded(torch, kernels, all_paths, smi)
    seconds["sync_sharded"] = time.perf_counter() - t
    t = time.perf_counter()
    cs.dplane_mesh_migrate(torch, kernels, all_paths, smi)
    seconds["migrate"] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - t0
    print("seconds: " + json.dumps(seconds), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
