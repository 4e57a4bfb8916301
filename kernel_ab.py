#!/usr/bin/env python3
"""Time K1 (ntHash), K2 (window argmin), K3 (minimizer compaction), K4
(Bloom-filter insert), K5 (the binned Bloom-filter sweep) and, where the
checkout has it, the unpack of the packed upload of one checkout of
ntsynt_tpu_torch on one CUDA card, through their public wrappers, so
that two commits can be compared on the same card in one run:

    python3 kernel_ab.py --root OLD_CHECKOUT --out a.json
    python3 kernel_ab.py --root . --out b.json

Each shape reports ms (device time: launches captured in one CUDA graph,
its replay timed with CUDA events) and wrapper_ms (CUDA events around a
Python loop of the same calls, which counts the wrapper's host time
wherever the card waits for it), with chip_smoke.py's timers. Inputs
are made from --seed with numpy: random 64-bit keys, and random codes
with 0.1% N for K1. K1 and K4 at the repeat walk's shape take a new
segment in each call, as the walk does. K3 compacts K2's output at
w=1000 over a legit mask with contig gaps, and at the refinement
shapes, its legit mask as bits where the checkout's K3 reads bits
(compact_minimizers takes a legit_offset), else as bytes; its wrapper
syncs the host once (twice before the one-pass design) to size its
result, so its device time captures the launches alone: compact_launch
where the checkout has it, else the two C entry points of the
three-kernel design with buffers sized beforehand. The unpack runs at
the main path's group (2^26 codes) and the JAX package's (2^26 + 24),
from random codes with 0.1% N packed by the checkout's host packer. K5
runs its four rows: insert and cascade (over a prev holding the first
half of the keys) of the main path's segment into the 100 Mbp filter's
size, and 2^22 keys into a 2^16-bit filter and into one 2^19-bit cell of
a 2^32-bit filter.
"""

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np

# (keys, w): the main path's segment at the default w, and the largest
# key counts the 2 x 100 Mbp main path's refinement rounds gave K2
K2_SHAPES = [(1 << 26, 1000), (12_102, 250), (3_370, 100), (3_370, 10)]
# (keys, bits): the main path's segment into the 100 Mbp common filter,
# and the repeat walk's segment into the 2^33-bit repeat filter
K4_SHAPES = [(1 << 26, 32), (1 << 20, 33)]
# (k-mers, k): the main path's segment and the repeat walk's segment
K1_SHAPES = [(1 << 26, 24), (1 << 20, 24)]
# (keys, w) whose windows K3 compacts: the main path's segment and the
# refinement shapes of K2_SHAPES
K3_SHAPES = [(1 << 26, 1000), (12_102, 250), (3_370, 100), (3_370, 10)]
# codes the unpack restores: the main path's group and the JAX package's
UNPACK_SHAPES = [1 << 26, (1 << 26) + 24]
# (row, keys, bits, mask of the keys' bits or None): K5's rows
K5_ROWS = [("insert", 1 << 26, 32, None), ("cascade", 1 << 26, 32, None),
           ("single_cell_2^16", 1 << 22, 16, None),
           ("one_cell_of_2^32", 1 << 22, 32, (1 << 19) - 1)]


def k3_device_fn(torch, sketch_device, arg, minv, legit):
    """A callable that launches K3 once on these inputs without a host
    sync, for either design of the checkout."""
    if hasattr(sketch_device, "compact_launch"):
        return lambda: sketch_device.compact_launch(arg, minv, legit)
    from ntsynt_tpu_torch.ops import _kernels

    lib, dev = _kernels.lib(), arg.device
    nw = arg.shape[0]
    m = sketch_device.compact_minimizers(arg, minv, legit)[0].shape[0]
    offsets = torch.empty(-(-nw // 1024), dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    pos = torch.empty(m, dtype=torch.int64, device=dev)
    hsh = torch.empty(m, dtype=torch.int64, device=dev)

    def launch():
        stream = _kernels.stream_ptr(dev)
        lib.ntsynt_compact_count(arg.data_ptr(), minv.data_ptr(), legit.data_ptr(), nw,
                                 offsets.data_ptr(), total.data_ptr(), stream)
        lib.ntsynt_compact_scatter(arg.data_ptr(), minv.data_ptr(), legit.data_ptr(), nw,
                                   offsets.data_ptr(), pos.data_ptr(), hsh.data_ptr(), stream)

    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout holding ntsynt_tpu_torch/")
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isfile(os.path.join(root, "ntsynt_tpu_torch", "__init__.py")):
        print(f"kernel_ab.py: no ntsynt_tpu_torch/ in {root}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import cuda_time_ms, device_ms

    sys.path.insert(0, root)
    from ntsynt_tpu_torch.ops import bf_sweep, bloom, nthash, sketch_device, winmin

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    big = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, 1 << 26,
                                        dtype=np.int64)).to(dev)
    valid = torch.from_numpy(rng.random(1 << 26) < 0.999).to(dev)
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, timeout=60).stdout.strip(),
           "k1": [], "k2": [], "k3": [], "k4": [], "k5": [], "unpack": []}
    codes_np = rng.integers(0, 4, (1 << 26) + 23, dtype=np.uint8)
    codes_np[rng.random(codes_np.shape[0]) < 0.001] = 4
    codes = torch.from_numpy(codes_np).to(dev)
    for n, k in K1_SHAPES:
        segs = [codes[i * n:(i + 1) * n + k - 1] for i in range(min(10, (1 << 26) // n))]
        fns = [lambda c=c: nthash.hash_kmers(c, k, n) for c in segs]
        reps = args.reps if n < 1 << 26 else 10
        out["k1"].append(dict(kmers=n, k=k, ms=device_ms(fns, reps),
                              wrapper_ms=cuda_time_ms(fns[0], reps)))
    bit_legit = "legit_offset" in inspect.signature(sketch_device.compact_minimizers).parameters
    for n, w in K3_SHAPES:
        key = nthash.hash_kmers(codes[: n + 23], 24, n)[0]
        arg, minv = winmin.window_argmin(key, w)
        del key
        nw = arg.shape[0]
        legit_np = np.ones(nw, dtype=bool)
        for gap in rng.integers(0, max(nw - 2000, 1), max(nw >> 20, 2)):
            legit_np[gap : gap + 1024] = False
        if bit_legit:
            legit_np = np.packbits(legit_np, bitorder="little")
        legit = torch.from_numpy(legit_np).to(dev)
        m = sketch_device.compact_minimizers(arg, minv, legit)[0].shape[0]
        reps = args.reps if n < 1 << 26 else 10
        out["k3"].append(dict(
            keys=n, w=w, windows=nw, minimizers=m, legit="bits" if bit_legit else "bytes",
            ms=device_ms(k3_device_fn(torch, sketch_device, arg, minv, legit), reps),
            wrapper_ms=cuda_time_ms(lambda: sketch_device.compact_minimizers(arg, minv, legit),
                                    reps)))
        del arg, minv, legit
    del codes
    torch.cuda.empty_cache()
    if importlib.util.find_spec("ntsynt_tpu_torch.ops.unpack") is not None:
        from ntsynt_tpu_torch.io import fasta as fio
        from ntsynt_tpu_torch.ops import unpack

        for n in UNPACK_SHAPES:
            src = codes_np[:n]  # one contig, code 4 past it
            p2, nb = (torch.from_numpy(a).to(dev) for a in fio.pack_stream(
                src, np.zeros(1, np.int64), np.array([len(src)]), np.zeros(1, np.int64), n))
            dst = unpack.unpack(p2, nb)
            out["unpack"].append(dict(
                codes=n, ms=device_ms(lambda: unpack.unpack(p2, nb, dst), args.reps),
                wrapper_ms=cuda_time_ms(lambda: unpack.unpack(p2, nb, dst), args.reps)))
            del p2, nb, dst
    for n, w in K2_SHAPES:
        keys = big[:n].clone()
        reps = args.reps if n < 1 << 20 else 5
        out["k2"].append(dict(
            keys=n, w=w,
            ms=device_ms(lambda: winmin.window_argmin(keys, w), reps),
            wrapper_ms=cuda_time_ms(lambda: winmin.window_argmin(keys, w), reps)))
    for n, bits in K4_SHAPES:
        words = torch.zeros((1 << bits) // 32, dtype=torch.int32, device=dev)
        segs = [(big[i * n:(i + 1) * n], valid[i * n:(i + 1) * n])
                for i in range(min(10, (1 << 26) // n))]
        fns = [lambda c=c, v=v: bloom.insert_words(words, c, v, bits) for c, v in segs]
        out["k4"].append(dict(
            keys=n, bits=bits, ms=device_ms(fns, 10),
            wrapper_ms=cuda_time_ms(fns[0], 10)))
        del words
        torch.cuda.empty_cache()
    for row, n, bits, mask in K5_ROWS:
        words = torch.zeros((1 << bits) // 32, dtype=torch.int32, device=dev)
        keys = big[:n] if mask is None else big[:n] & mask
        v = valid[:n]
        if row == "cascade":
            prev = torch.zeros_like(words)
            bf_sweep.insert_segment(prev, keys[: n // 2], v[: n // 2], bits)
            fn = lambda: bf_sweep.cascade_segment(prev, words, keys, v, bits)  # noqa: E731
        else:
            fn = lambda: bf_sweep.insert_segment(words, keys, v, bits)  # noqa: E731
        out["k5"].append(dict(row=row, keys=n, bits=bits, ms=device_ms(fn, 10),
                              wrapper_ms=cuda_time_ms(fn, 10)))
        del words, keys, fn
        prev = None
        torch.cuda.empty_cache()
    with open(args.out, "w") as fout:
        json.dump(out, fout, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
