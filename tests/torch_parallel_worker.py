"""Worker process of tests/test_torch_parallel.py (not a test module):
one rank of a gloo process group on the CPU. Runs the port's mesh
functions on the inputs in DATA_DIR and saves this rank's results to
OUT_DIR/rank<RANK>.npz.

Usage: python torch_parallel_worker.py RANK WORLD PORT DATA_DIR OUT_DIR
"""

import os
import sys

import numpy as np
import torch


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    data, out = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)

    import torch.distributed as dist

    from ntsynt_tpu_torch.io.fasta import read_fasta
    from ntsynt_tpu_torch.ops import bf_build, sketch
    from ntsynt_tpu_torch.ops.bloom import HostModBloomFilter, load_bf
    from ntsynt_tpu_torch.parallel import mesh as pmesh
    from ntsynt_tpu_torch.parallel import multihost

    assert multihost.initialize(f"localhost:{port}", world, rank, device="cpu") == "gloo"
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, "gloo")
    inp = np.load(os.path.join(data, "inputs.npz"))

    def genome(name):
        return read_fasta(os.path.join(data, name))

    res = {}
    x = torch.from_numpy(inp["or_words"][rank])
    res["or"] = pmesh.allreduce_or(x, mesh).numpy()
    once, twice = pmesh._allreduce_dup(x, mesh)
    res["dup_once"], res["dup_twice"] = once.numpy(), twice.numpy()
    assert torch.equal(x, torch.from_numpy(inp["or_words"][rank]))  # inputs left as they were

    # rank 0's value on every rank: an object, a device filter, a host one
    res["bcast_obj"] = np.asarray(pmesh.broadcast_object(
        np.arange(5, dtype=np.int64) * 7 if rank == 0 else None, mesh))
    mine = load_bf(os.path.join(data, "s_common.bf"), device="cpu") if rank == 0 else None
    res["bcast_words"] = pmesh.broadcast_bf(mine, mesh).words.numpy()
    host = HostModBloomFilter(8 * 4004 - 3, 24, inp["or_words"][0].view(np.uint8).copy())
    got = pmesh.broadcast_bf(host if rank == 0 else None, mesh)
    assert isinstance(got, HostModBloomFilter) and (got.num_bits, got.k) == (8 * 4004 - 3, 24)
    res["bcast_host_bits"] = got.bits

    bf_build.SEG_KMERS = 1 << 9  # several K1/K4 launches a slab
    sketch.GROUP_KMERS = 1 << 10  # several groups a slab, two segments each
    common = pmesh.distributed_common_bf([genome("cb.fa"), genome("ca.fa")], 20, fpr=0.025,
                                         mesh=mesh)
    res["common"] = common.words.numpy()
    res["repeat"] = pmesh.distributed_repeat_bf([genome("r.fa")], 20, mesh=mesh,
                                                seg_max=1 << 9).words.numpy()

    # a genome of short contigs only: no rank has a legit window
    sk = pmesh.sharded_sketch_genome(genome("t.fa"), 24, 60, mesh=mesh)
    res["sk_tiny_ctg"], res["sk_tiny_pos"], res["sk_tiny_hash"] = (sk.contig_idx, sk.positions,
                                                                   sk.hashes)
    g = genome("s.fa")
    cbf = load_bf(os.path.join(data, "s_common.bf"), device="cpu")
    rbf = load_bf(os.path.join(data, "s_repeat.bf"), device="cpu")
    for name, c, r in (("none", None, None), ("common", cbf, None), ("both", cbf, rbf)):
        sk = pmesh.sharded_sketch_genome(g, 24, 60, mesh=mesh, seg_max=1 << 10, common_bf=c,
                                         repeat_bf=r)
        res[f"sk_{name}_ctg"], res[f"sk_{name}_pos"] = sk.contig_idx, sk.positions
        res[f"sk_{name}_hash"], res[f"sk_{name}_canon"] = sk.hashes, sk.canon

    # the step functions: this rank's rows of the tiles
    k, w, chunk, bits = (int(v) for v in inp["step_kwcb"])
    b = inp["tiles"].shape[0] // world

    def rows(name):
        return torch.from_numpy(inp[name][rank * b : (rank + 1) * b])

    zeros = torch.zeros((1 << bits) // 32, dtype=torch.int32)
    arg, valid, words = pmesh.sharded_sketch_step(mesh, k, w, chunk, bits)(rows("tiles"), zeros)
    res["step_arg"], res["step_valid"], res["step_words"] = arg.numpy(), valid.numpy(), words.numpy()
    res["probe_words"] = pmesh.sharded_common_bf_probe_step(mesh, k, chunk, bits)(
        rows("tiles_g2"), words, zeros).numpy()
    arg, valid = pmesh.sharded_filtered_sketch_step(mesh, k, w, chunk, bits, bits)(
        rows("tiles"), words, torch.from_numpy(res["probe_words"]))
    res["filtered_arg"], res["filtered_valid"] = arg.numpy(), valid.numpy()

    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
