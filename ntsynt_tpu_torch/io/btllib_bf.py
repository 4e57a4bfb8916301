"""btllib KmerBloomFilter (.bf) container read/write.

The reference's common BF artifact is a btllib KmerBloomFilter file
(src/ntsynt_make_common_bf.cpp:162-165 ``bf->save(prefix + ".bf")``,
loaded by bin/ntsynt_synteny.py:606 via btllib.KmerBloomFilter). The
btllib v6 on-disk layout (btllib bloom_filter.hpp, BloomFilter::save /
parse_header) is:

    [BTLKmerBloomFilter_v6]        <- signature line (plain BFs use
    bytes = <N>                       [BTLBloomFilter_v6])
    hash_fn = "ntHash_v2"
    hash_num = <H>
    k = <K>                        <- Kmer variant only
    [HeaderEnd]
    <N raw bytes>                  <- the bit array, bit i at
                                      byte i//8, mask 1 << (i % 8)

The header region is TOML (btllib parses it with cpptoml), so key order
is immaterial; the data follows immediately after the "[HeaderEnd]\\n"
line. Membership of hash h is bit ``h % (bytes * 8)``.

Interop notes:
  * BloomFilter words are little-endian uint32 with bit index
    ``canon mod 2^n`` at word i>>5 / mask 1<<(i&31) (ops/bloom.bit_index)
    — byte-for-byte identical to btllib's uint8 layout under
    ``.astype('<u4').tobytes()``, so pow2 filters export losslessly
    (h % 2^n == h & (2^n - 1)).
  * Reference-built filters are generally NOT pow2-sized: those load
    into ops.bloom.HostModBloomFilter (exact ``h % num_bits`` probing
    on host); the sketch probes them on the host (ops/sketch_device).
  * btllib's BF key for k-mers is the ntHash2 canonical hash —
    the same pre-mix f+r key this package uses (ops/nthash.py).

A NumPy-only copy of the JAX package's module of the same name, so that
this package never imports the JAX package.
"""

import re

import numpy as np

KMER_SIGNATURE = "BTLKmerBloomFilter_v6"
PLAIN_SIGNATURE = "BTLBloomFilter_v6"
HASH_FN = "ntHash_v2"
HEADER_END = "[HeaderEnd]"

_KV_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.+?)\s*$")


def write_btllib_bf_bytes(path: str, raw: bytes, k: int,
                          hash_num: int = 1) -> str:
    """Write a btllib KmerBloomFilter container from a raw byte array
    (btllib bit layout: bit i at byte i//8, mask 1 << (i % 8)). The
    modulus btllib will probe with is len(raw)*8."""
    header = (
        f"[{KMER_SIGNATURE}]\n"
        f"bytes = {len(raw)}\n"
        f'hash_fn = "{HASH_FN}"\n'
        f"hash_num = {hash_num}\n"
        f"k = {k}\n"
        f"{HEADER_END}\n"
    )
    with open(path, "wb") as fout:
        fout.write(header.encode())
        fout.write(raw)
    return path


def write_btllib_bf(path: str, words: np.ndarray, num_bits: int, k: int,
                    hash_num: int = 1) -> str:
    """Write a btllib KmerBloomFilter container from a uint32 word array.

    num_bits must equal len(words)*32 (the modulus btllib will use is
    bytes*8 = num_bits, so membership semantics are preserved exactly
    for pow2 ntsynt_tpu filters).
    """
    raw = np.asarray(words).astype("<u4").tobytes()
    if num_bits != len(raw) * 8:
        raise ValueError(
            f"num_bits {num_bits} != 8 * {len(raw)} bytes: btllib probes "
            "h % (bytes*8), which would change membership"
        )
    return write_btllib_bf_bytes(path, raw, k, hash_num)


def sniff_btllib(path: str) -> bool:
    """True if the file starts with a btllib BF signature."""
    with open(path, "rb") as fin:
        head = fin.read(64)
    return head.startswith(b"[BTL") and b"BloomFilter" in head[:40]


def read_btllib_bf(path: str):
    """Parse a btllib BF container -> (raw bytes, meta dict).

    meta: {"bytes": int, "hash_num": int, "k": int|None, "hash_fn": str,
           "signature": str}. Tolerates unknown header keys and either
    signature (plain/Kmer).
    """
    with open(path, "rb") as fin:
        blob = fin.read()
    end_marker = (HEADER_END + "\n").encode()
    idx = blob.find(end_marker)
    if idx < 0:
        raise ValueError(f"{path}: no {HEADER_END} — not a btllib BF")
    header_text = blob[:idx].decode("utf-8", "replace")
    data = blob[idx + len(end_marker):]
    lines = header_text.splitlines()
    if not lines or not lines[0].startswith("[BTL"):
        raise ValueError(f"{path}: missing btllib signature line")
    signature = lines[0].strip().strip("[]")
    meta = {"signature": signature, "k": None, "hash_num": 1, "hash_fn": ""}
    for line in lines[1:]:
        m = _KV_RE.match(line)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if val.startswith('"') and val.endswith('"'):
            meta[key] = val[1:-1]
        else:
            try:
                meta[key] = int(val)
            except ValueError:
                meta[key] = val
    nbytes = meta.get("bytes")
    if nbytes is None:
        raise ValueError(f"{path}: btllib header missing 'bytes'")
    if len(data) < nbytes:
        raise ValueError(
            f"{path}: truncated bit array ({len(data)} < {nbytes} bytes)"
        )
    return data[:nbytes], meta


def load_btllib_bf(path: str, device="cuda"):
    """Load a btllib .bf into the best-fitting filter.

    pow2 bit counts -> BloomFilter on ``device`` (device-probe capable);
    anything else -> HostModBloomFilter (exact h % num_bits on host).
    """
    from ..ops import bloom

    data, meta = read_btllib_bf(path)
    num_bits = meta["bytes"] * 8
    k = meta["k"] if meta["k"] is not None else 0
    if meta.get("hash_num", 1) != 1:
        raise ValueError(
            f"{path}: hash_num={meta['hash_num']} unsupported (ntSynt "
            "builds all its filters with 1 hash fn, "
            "src/ntsynt_make_common_bf.cpp:19)"
        )
    if num_bits and num_bits & (num_bits - 1) == 0:
        pad = (-len(data)) % 4
        words = np.frombuffer(data + b"\x00" * pad, dtype="<u4")
        return bloom.BloomFilter.from_u32(words, num_bits, k, device=device)
    return bloom.HostModBloomFilter.from_bytes(data, num_bits, k)
