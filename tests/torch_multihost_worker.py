"""Worker process for ``tests/test_torch_multihost.py``: one rank of a
two-process gloo group on the CPU.

    python tests/torch_multihost_worker.py <rank> <ranks> <port> <out.json>

Each rank joins through ``init_distributed`` (``tcp://127.0.0.1:<port>``),
builds the global (data, node) mesh over 4 CPU entries of its own
(``make_global_mesh(node_devices_per_host=2)``: a (4, 2) mesh, data rows
split between the ranks), and runs ``sharded_sweep``, the mesh engine
(``pipeline_sweep(mesh=)``, with counters, so the per-round histogram sum
crosses the ranks) and ``sm_node_sharded``.  Rank 0 writes the gathered
results as JSON.  The cases are ``CASES`` in the test module.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def main() -> None:
    rank, ranks = int(sys.argv[1]), int(sys.argv[2])
    port, out_path = sys.argv[3], sys.argv[4]

    import torch.distributed as dist

    from ba_tpu_torch.parallel import init_distributed, make_global_mesh
    from test_torch_multihost import run_cases

    assert init_distributed(f"127.0.0.1:{port}", ranks, rank, device="cpu") == ranks
    mesh = make_global_mesh(node_devices_per_host=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2 * ranks, "node": 2} and mesh.group is not None
    assert len(mesh.local_positions) == 4
    results = run_cases(mesh)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    main()
