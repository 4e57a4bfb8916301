"""Multi-process (>= 1 rank) runs over torch.distributed.

The torch counterpart of the JAX package's multi-host entry
(ntsynt_tpu/parallel/multihost.py). One process per rank, each with one
device, joins one process group; genome code slabs are partitioned per
rank (parallel/mesh.py: each rank lays out and uploads only its own
slab), and the two global exchanges are collectives: the Bloom-filter
words' OR all-reduce and the all-gather of the compacted selections.
The host stages are deterministic and run alike on every rank from the
gathered selections, so all ranks hold the same blocks; only rank 0
writes artifacts.

Usage: one invocation per rank, the same arguments everywhere but the
rank:

    python -m ntsynt_tpu_torch.parallel.multihost \\
        --coordinator host0:29500 --num-processes 2 --process-id 0 -- \\
        genomeA.fa genomeB.fa -d 1 -p out

The backend is NCCL for the default --device cuda and gloo for --device
cpu (``--backend`` overrides it); a rank's card is ``process_id %
torch.cuda.device_count()`` (``CUDA_VISIBLE_DEVICES`` picks the cards).
Checked on the CPU by two- and three-process gloo runs whose blocks
equal a single-process run's (tests/test_torch_multihost.py).
"""

import argparse
import json
import sys

import torch
import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_ids=None, backend: str | None = None, device: str = "cuda") -> str:
    """Join the process group at tcp://<coordinator_address> as rank
    process_id of num_processes, with this rank's device: for "cuda" the
    card local_device_ids names (one id, or a list of one), else
    process_id % torch.cuda.device_count(), made current. backend
    defaults to NCCL for "cuda" and gloo for "cpu". Ends with a barrier,
    so a group that cannot form fails here. Returns the backend."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda rank needs torch.cuda.is_available(); use --device cpu")
        ids = [local_device_ids] if isinstance(local_device_ids, int) else local_device_ids
        if ids is not None and len(ids) != 1:
            raise ValueError("one device per process: local_device_ids must name one card")
        dev = torch.device("cuda", ids[0] if ids else process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev  # NCCL binds this card rather than guess one by rank
    elif backend == "nccl":
        raise ValueError("the nccl backend needs --device cuda")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)
    dist.barrier()
    return backend


def build_parser():
    parser = argparse.ArgumentParser(
        prog="ntsynt-tpu-torch-multihost",
        description=(
            "Run the ntsynt-tpu-torch pipeline over a torch.distributed process group: "
            "start this once per rank with identical pipeline arguments after '--'"
        ),
    )
    parser.add_argument("--coordinator", required=True,
                        help="host:port of the rank-0 coordinator")
    parser.add_argument("--num-processes", required=True, type=int)
    parser.add_argument("--process-id", required=True, type=int)
    parser.add_argument("--backend", choices=["nccl", "gloo"],
                        help="collective backend [nccl for --device cuda, gloo for --device cpu]")
    parser.add_argument("cli_args", nargs=argparse.REMAINDER,
                        help="pipeline arguments (see ntsynt-tpu-torch --help), preceded by --")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .. import cli
    from ..ops import _kernels

    rest = args.cli_args
    if rest and rest[0] == "--":
        rest = rest[1:]
    rest = list(rest) + ["--mesh"]
    device = cli.build_parser().parse_args(rest).device
    backend = initialize(args.coordinator, args.num_processes, args.process_id,
                         backend=args.backend, device=device)
    try:
        print(
            f"[multihost] process {dist.get_rank()}/{dist.get_world_size()}: 1 local / "
            f"{dist.get_world_size()} global devices ({device}, {backend})",
            flush=True,
        )
        rc = cli.main(rest)
        # this rank's kernel launches (0 on the CPU, where the plain
        # versions run)
        print(f"[multihost] process {dist.get_rank()} launches {json.dumps(_kernels.LAUNCHES)}",
              flush=True)
        if device.startswith("cuda"):
            # the rank's device-memory high-water (torch's allocator)
            print(f"[multihost] process {dist.get_rank()} max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()}", flush=True)
        return rc
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
