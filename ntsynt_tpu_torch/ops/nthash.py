"""ntHash-compatible canonical k-mer hashing (PyTorch + CUDA kernel K1).

The printed hash of a k-mer (what indexlr prints and orders minimizers
by) and its canonical hash (the Bloom-filter key) are

    f(s)   = XOR_{j<k} srol^(k-1-j)( SEED[s_j] )          # forward strand
    r(s)   = XOR_{j<k} srol^j( SEED[complement(s_j)] )    # reverse strand
    c(s)   = (f + r) mod 2^64                              # canonical
    out(s) = t ^ (t >> 27),  t = c * ((1 ^ (k * MS)) mod 2^64)

with ``srol`` the ntHash2 split rotate (independent left rotations of
the low 33 and high 31 bits) and MS = 0x90b45d39fb6da1fa. Per-position
tables ``TF[j][b]``, ``TR[j][b]`` turn hashing into k independent
lookup+XOR steps (the plain version). The kernel rolls instead: with
``sror`` the inverse of ``srol`` and SEED[N] = 0,

    f_{i+1} = srol(f_i) ^ srol^k(SEED[s_i]) ^ SEED[s_{i+k}]
    r_{i+1} = sror(r_i) ^ sror(SEED[comp s_i]) ^ srol^(k-1)(SEED[comp s_{i+k}])

and the first k-mer of a run is the same "in" step applied k times from
f = r = 0 (``roll_tables``). An N adds nothing to either sum, so the
recurrence stays exact across N; validity is tracked apart.

Bases are coded A=0, C=1, G=2, T=3, N/other=4. Hashes are ``int64``
tensors holding the uint64 bit pattern: additions and multiplications
wrap mod 2^64 as in uint64, and a logical right shift is an arithmetic
shift followed by a mask.

``hash_kmers`` launches the CUDA kernel (csrc/nthash.cu, rolling over
codes staged in shared memory) for a CUDA tensor and runs
``hash_kmers_plain`` for a CPU tensor.
"""

import functools

import numpy as np
import torch

from . import _kernels

SEED_TAB = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456, 0],
    dtype=np.uint64,
)
COMP_CODE = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N
MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27
_U64MASK = (1 << 64) - 1
SENTINEL = -1  # all-ones uint64 as int64: the key of an invalid k-mer


def _srol1_np(x: np.ndarray) -> np.ndarray:
    """ntHash2 split rotate by one: bits[32:0] (33 wide) and bits[63:33]
    (31 wide) rotate left independently."""
    x = x.astype(np.uint64)
    m = ((x & np.uint64(0x8000000000000000)) >> np.uint64(30)) | (
        (x & np.uint64(0x100000000)) >> np.uint64(32)
    )
    return ((x << np.uint64(1)) & np.uint64(0xFFFFFFFDFFFFFFFF)) | m


@functools.lru_cache(maxsize=None)
def hash_tables(k: int):
    """(TF, TR) uint64 [k, 5]: TF[j][b] = srol^(k-1-j)(SEED[b]),
    TR[j][b] = srol^j(SEED[COMP[b]])."""
    rots = np.empty((k, 5), dtype=np.uint64)
    rots[0] = SEED_TAB
    for i in range(1, k):
        rots[i] = _srol1_np(rots[i - 1])
    tf = rots[::-1].copy()
    tr = rots[:, COMP_CODE].copy()
    return tf, tr


def _sror1_np(x: np.ndarray) -> np.ndarray:
    """Inverse of _srol1_np: bits[32:0] and bits[63:33] rotate right."""
    x = x.astype(np.uint64)
    m = ((x & np.uint64(1)) << np.uint64(32)) | ((x & np.uint64(1 << 33)) << np.uint64(30))
    return ((x >> np.uint64(1)) & np.uint64(0xFFFFFFFEFFFFFFFF)) | m


SROL_PERIOD = 33 * 31  # srol^SROL_PERIOD is the identity


def _srol_np(x: np.ndarray, times: int) -> np.ndarray:
    for _ in range(times % SROL_PERIOD):
        x = _srol1_np(x)
    return x.astype(np.uint64)


@functools.lru_cache(maxsize=None)
def roll_tables(k: int):
    """(out_f, in_f, out_r, in_r) uint64 [5] each, for the rolling
    recurrence: a k-mer's hashes step to the next one's by
      f' = srol(f) ^ out_f[outgoing] ^ in_f[incoming]
      r' = sror(r) ^ out_r[outgoing] ^ in_r[incoming]
    with out_f[b] = srol^k(SEED[b]), in_f[b] = SEED[b],
    out_r[b] = sror(SEED[COMP[b]]) and in_r[b] = srol^(k-1)(SEED[COMP[b]]).
    Entry 4 (N) is 0 in all four."""
    comp = SEED_TAB[COMP_CODE]
    return _srol_np(SEED_TAB, k), SEED_TAB.copy(), _sror1_np(comp), _srol_np(comp, k - 1)


def mix_multiplier(k: int) -> int:
    """The nte64(i=1) multiplier: (1 ^ (k * MULTISEED)) mod 2^64."""
    return (1 ^ ((k * MULTISEED) & _U64MASK)) & _U64MASK


def as_int64(u: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


# ---------------------------------------------------------------------------
# NumPy oracle
# ---------------------------------------------------------------------------


def hash_sequence_np(codes: np.ndarray, k: int):
    """Hash every k-mer of a coded sequence on the host.

    Returns (canon, out, valid): uint64 [L-k+1] canonical hashes, uint64
    [L-k+1] printed hashes, and bool [L-k+1] validity (False where the
    k-mer holds any non-ACGT code).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    tf, tr = hash_tables(k)
    f = np.zeros(n, dtype=np.uint64)
    r = np.zeros(n, dtype=np.uint64)
    bad = np.zeros(n, dtype=bool)
    for j in range(k):
        cj = np.minimum(codes[j : j + n], 4)
        f ^= tf[j][cj]
        r ^= tr[j][cj]
        bad |= cj >= 4
    canon = f + r
    t = canon * np.uint64(mix_multiplier(k))
    out = t ^ (t >> np.uint64(MULTISHIFT))
    return canon, out, ~bad


def unmix_np(out: np.ndarray, k: int) -> np.ndarray:
    """Invert the nte64 mix: printed hash -> canonical hash (the
    xorshift undoes in three substitutions; the odd multiplier has an
    inverse mod 2^64)."""
    out = np.asarray(out, dtype=np.uint64)
    t = out.copy()
    for _ in range(2):
        t = out ^ (t >> np.uint64(MULTISHIFT))
    inv = pow(mix_multiplier(k), -1, 1 << 64)
    return (t * np.uint64(inv)).astype(np.uint64)


def hash_kmer_np(seq: str, k: int) -> int:
    """Hash one k-mer string; returns its printed hash."""
    lut = np.full(256, 4, dtype=np.uint8)
    for i, c in enumerate("ACGT"):
        lut[ord(c)] = i
        lut[ord(c.lower())] = i
    codes = lut[np.frombuffer(seq.encode(), dtype=np.uint8)]
    _, out, valid = hash_sequence_np(codes, k)
    if len(out) != 1 or not valid[0]:
        raise ValueError(f"not a valid {k}-mer: {seq!r}")
    return int(out[0])


# ---------------------------------------------------------------------------
# K1: plain PyTorch version and kernel wrapper
# ---------------------------------------------------------------------------


def _tables_i64(k: int) -> np.ndarray:
    """TF then TR, flattened [2*k*5], as int64 bit patterns."""
    tf, tr = hash_tables(k)
    return np.concatenate([tf.reshape(-1), tr.reshape(-1)]).view(np.int64)


def hash_kmers_plain(codes: torch.Tensor, k: int, n_kmers: int):
    """Plain PyTorch K1: (key int64, canon int64, valid bool), each
    [n_kmers], for the k-mers starting at codes[0 .. n_kmers)."""
    tabs = torch.from_numpy(_tables_i64(k)).to(codes.device).view(2, k, 5)
    f = torch.zeros(n_kmers, dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    bad = torch.zeros(n_kmers, dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = codes[j : j + n_kmers].long()
        bad |= cj >= 4
        cj = cj.clamp_(max=4)
        f ^= tabs[0, j][cj]
        r ^= tabs[1, j][cj]
    canon = f + r
    t = canon * as_int64(mix_multiplier(k))
    out = t ^ srl(t, MULTISHIFT)
    valid = ~bad
    key = torch.where(valid, out, torch.full_like(out, SENTINEL))
    return key, canon, valid


# K1's launch (csrc/nthash.cu): blocks of THREADS threads, each thread
# rolling a run of m * PHASE consecutive k-mers (PHASE: the k-mers whose
# outputs go out together). A warp's stores of one phase cover 32 lines
# at a stride of m lines: m = 1 makes them contiguous, which measured
# fastest at k=24; a longer k takes the smallest odd m (no power-of-two
# stride) that keeps the direct hash of a run's first k-mer to at most
# two steps a k-mer, and small segments cut m down so that the grid
# keeps BLOCKS_PER_SM blocks per SM. Codes of k <= MAX_STAGED_K are all
# staged in shared memory; a larger k reads the incoming codes from
# device memory.
THREADS = 128
PHASE = 16
MAX_RUN = 240
BLOCKS_PER_SM = 2
MAX_STAGED_K = 4096


def nthash_plan(n_kmers: int, k: int, sm_count: int):
    """(run, tiles, staged) of K1 for n_kmers k-mers on a card of
    sm_count SMs: the k-mers a thread rolls, the blocks of THREADS * run
    k-mers that cover n_kmers, and whether every code a block reads is
    staged in shared memory."""
    m = min(MAX_RUN // PHASE, -(-k // (2 * PHASE)) | 1)
    while m > 1 and -(-n_kmers // (THREADS * PHASE * m)) < BLOCKS_PER_SM * sm_count:
        m -= 1
    run = PHASE * m
    return run, -(-n_kmers // (THREADS * run)), k <= MAX_STAGED_K


@functools.lru_cache(maxsize=None)
def _roll_tables_u64(k: int) -> np.ndarray:
    """The kernel's table layout, uint64 [20]: (out_f, out_r) for codes
    0-4, then (in_f, in_r) for codes 0-4 (cached: read-only)."""
    out_f, in_f, out_r, in_r = roll_tables(k)
    tab = np.ascontiguousarray(
        np.concatenate([np.stack([out_f, out_r], 1).reshape(-1),
                        np.stack([in_f, in_r], 1).reshape(-1)]), dtype=np.uint64)
    tab.setflags(write=False)
    return tab


@functools.lru_cache(maxsize=None)
def _roll_tables_ptr(k: int) -> int:
    """Host address of _roll_tables_u64(k), which the launch reads (the
    cached array stays alive)."""
    return _roll_tables_u64(k).ctypes.data


def hash_kmers(codes: torch.Tensor, k: int, n_kmers: int):
    """Hash the n_kmers k-mers starting at codes[0 .. n_kmers).

    Args:
      codes: uint8 [>= n_kmers + k - 1] base codes (any code >= 4 is N).
    Returns (key int64, canon int64, valid bool), each [n_kmers]: key is
    the printed hash, or the all-ones sentinel (-1) for an invalid k-mer;
    canon is the canonical hash (unmasked).
    """
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError("hash_kmers: codes must be a 1-D uint8 tensor")
    if k < 1 or n_kmers < 0 or codes.shape[0] < n_kmers + k - 1:
        raise ValueError("hash_kmers: need k >= 1 and codes of at least n_kmers + k - 1")
    if codes.device.type == "cpu":
        return hash_kmers_plain(codes, k, n_kmers)
    _kernels.require_cuda("hash_kmers", codes)
    dev = codes.device
    key = torch.empty(n_kmers, dtype=torch.int64, device=dev)
    canon = torch.empty(n_kmers, dtype=torch.int64, device=dev)
    valid = torch.empty(n_kmers, dtype=torch.bool, device=dev)
    if n_kmers == 0:
        return key, canon, valid
    run, _, _ = nthash_plan(n_kmers, k, _kernels.sm_count(dev.index))
    rc = _kernels.lib().ntsynt_nthash(
        codes.data_ptr(), n_kmers, k, _roll_tables_ptr(k), mix_multiplier(k), run,
        key.data_ptr(), canon.data_ptr(), valid.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check("nthash", rc)
    _kernels.count("nthash", n_kmers, k)
    return key, canon, valid
