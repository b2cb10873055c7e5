"""Snapshot wire codec for live KV migration (port of
``kubetpu/router/migration.py``, with bfloat16 added).

``PagedDecodeServer.snapshot_slot`` returns a host-side dict whose
``pages`` entry holds the pool's pages as stored (dense pools: ``k``/``v``;
kv_int8 pools: the quantized ``k_q``/``k_s``/``v_q``/``v_s`` pairs — the
codec never dequantizes). JSON can't carry them, and one monolithic body
would couple the transfer's fault surface to the snapshot size — so the
wire protocol splits a snapshot into:

- **meta**: the JSON-safe fields plus an ``arrays`` manifest
  (name/dtype/shape per array, in blob order);
- **blob**: every array's raw bytes concatenated in manifest order,
  shipped as base64 CHUNKS of ``chunk_bytes`` each.

The format is the JAX package's byte for byte: the manifest names dtypes
as numpy prints them (``float32``, ``float16``, ``int8``, ``bfloat16``)
and the blob holds the same raw bytes in the same order, so a blob either
package writes decodes under the other. numpy holds every stored dtype
but bfloat16 (the JAX side gets it from ml_dtypes, which the port does
not have): a bf16 array is a ``torch.bfloat16`` CPU tensor here, written
as its 16-bit patterns and read back through a 16-bit integer view. f32,
f16 and int8 arrays decode as numpy.

``encode_snapshot`` produces (meta, blob); ``decode_snapshot`` is the
exact inverse (length-checked — a short blob means a lost chunk and must
fail loudly, never restore garbage KV). ``blob_chunks`` is the splitter
the replica's ``/migrate_in`` phases ride.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

DEFAULT_CHUNK_BYTES = 256 * 1024

# the manifest's name for torch.bfloat16, as numpy prints the ml_dtypes type
BF16 = "bfloat16"

PageArray = Union[np.ndarray, torch.Tensor]


def encode_array(name: str, arr: PageArray) -> Tuple[dict, bytes]:
    """(manifest entry, raw bytes) of one page array: a numpy array or a
    CPU tensor; bf16 goes as its 16-bit patterns under ``"bfloat16"``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return ({"name": name, "dtype": BF16, "shape": list(t.shape)},
                    t.view(torch.int16).numpy().tobytes())
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return ({"name": name, "dtype": str(arr.dtype), "shape": list(arr.shape)},
            arr.tobytes())


def decode_array(spec: dict, raw: bytes) -> PageArray:
    """The array of a manifest entry (dtype, shape) from its raw bytes:
    numpy, or a ``torch.bfloat16`` CPU tensor under ``"bfloat16"``."""
    if spec["dtype"] == BF16:
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(spec["shape"])
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(spec["dtype"])).reshape(
        spec["shape"]).copy()


def _itemsize(dtype: str) -> int:
    return 2 if dtype == BF16 else np.dtype(dtype).itemsize


def encode_snapshot(snap: dict) -> Tuple[dict, bytes]:
    """Split a slot snapshot into (JSON-safe meta, raw page blob)."""
    meta = {k: v for k, v in snap.items() if k != "pages"}
    specs: List[dict] = []
    parts: List[bytes] = []
    for name in sorted(snap.get("pages", {})):
        spec, raw = encode_array(name, snap["pages"][name])
        specs.append(spec)
        parts.append(raw)
    meta["arrays"] = specs
    return meta, b"".join(parts)


def decode_snapshot(meta: dict, blob: bytes) -> dict:
    """Rebuild the snapshot dict ``restore_slot`` consumes. Raises
    ValueError when the blob's length disagrees with the manifest — a
    lost or duplicated chunk must refuse the restore, not scribble
    half a cache."""
    snap = {k: v for k, v in meta.items() if k != "arrays"}
    pages: Dict[str, PageArray] = {}
    off = 0
    for spec in meta.get("arrays", ()):
        n = (int(np.prod(spec["shape"], dtype=np.int64))
             * _itemsize(spec["dtype"]))
        if off + n > len(blob):
            raise ValueError(
                f"snapshot blob truncated: need {off + n} bytes for "
                f"{spec['name']!r}, have {len(blob)}")
        pages[spec["name"]] = decode_array(spec, blob[off:off + n])
        off += n
    if off != len(blob):
        raise ValueError(
            f"snapshot blob has {len(blob) - off} trailing bytes — "
            f"manifest and chunks disagree")
    snap["pages"] = pages
    return snap


def blob_chunks(blob: bytes,
                chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> List[bytes]:
    """Split *blob* into wire chunks (always at least one, so the
    commit leg can assert it saw every sequence number even for an
    empty manifest)."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    if not blob:
        return [b""]
    return [blob[i:i + chunk_bytes]
            for i in range(0, len(blob), chunk_bytes)]


def chunk_b64(chunk: bytes) -> str:
    return base64.b64encode(chunk).decode("ascii")


def chunk_unb64(data: str) -> bytes:
    return base64.b64decode(data.encode("ascii"), validate=True)


# -- page-span streaming (the disaggregated prefill/decode handoff) -----------
#
# A full-slot snapshot ships each pool array as ONE manifest entry. The
# disaggregated handoff streams pages AS PREFILL COMPLETES THEM, so the blob
# grows span by span: each completed page range is its own set of manifest
# entries ("k@5" = the k pages starting at logical page 5), encoded and
# chunked independently, appended to the transfer in ship order.
# ``assemble_spans`` stitches them back into the contiguous per-field
# arrays ``restore_slot`` consumes — refusing gaps and overlaps, because a
# hole would restore a slot with missing KV.


def span_name(field: str, start_page: int) -> str:
    """Manifest name for *field*'s pages starting at logical page
    *start_page* (``"k@5"``)."""
    return f"{field}@{int(start_page)}"


def _concat_pages(arrays: List[PageArray]) -> PageArray:
    """Join one field's spans along the page axis (1): tensors (bf16) with
    torch, numpy arrays with numpy."""
    if isinstance(arrays[0], torch.Tensor):
        return torch.cat(arrays, dim=1)
    return np.concatenate(arrays, axis=1)


def assemble_spans(pages: Dict[str, PageArray],
                   from_page: int) -> Dict[str, PageArray]:
    """Stitch span-named arrays back into contiguous per-field arrays
    whose page axis starts at *from_page* (the transfer's
    ``ship_from_page``). Plain (span-free) names pass through untouched
    — the full-snapshot path. Raises ValueError on a gap, overlap, or
    mixed plain+span naming for one field."""
    if not any("@" in name for name in pages):
        return dict(pages)
    spans: Dict[str, List[Tuple[int, PageArray]]] = {}
    for name, arr in pages.items():
        if "@" not in name:
            raise ValueError(
                f"transfer mixes span-named and plain page arrays "
                f"({name!r} next to spans)")
        field, _, start = name.partition("@")
        spans.setdefault(field, []).append((int(start), arr))
    out: Dict[str, PageArray] = {}
    for field, parts in spans.items():
        parts.sort(key=lambda p: p[0])
        expect = from_page
        for start, arr in parts:
            if start != expect:
                raise ValueError(
                    f"span {field}@{start} does not continue at page "
                    f"{expect} — transfer has a "
                    f"{'gap' if start > expect else 'overlap'}")
            expect = start + arr.shape[1]
        out[field] = (parts[0][1] if len(parts) == 1 else
                      _concat_pages([a for _s, a in parts]))
    return out


# -- peer prefix fetch (the tiered KV cache's peer tier) ----------------------
#
# The cross-replica tier ships ONE page span per fetch, riding the same
# manifest + b64-chunk machinery as a migration transfer folded into a
# single JSON body: a prefix fetch is read-only and at-most-once by
# construction (the exporter mutates nothing, the importer's tree-insert
# consumes nothing it already covers).


def encode_span_payload(pages: Dict[str, PageArray], from_page: int,
                        chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> dict:
    """JSON-safe encoding of one stored-layout page-span dict (page axis
    1): span-named manifest + base64 chunks of the concatenated blob.
    ``decode_span_payload`` is the exact inverse."""
    meta, blob = encode_snapshot({"pages": {
        span_name(field, from_page): arr
        for field, arr in pages.items()}})
    return {
        "arrays": meta["arrays"],
        "from_page": int(from_page),
        "chunks": [chunk_b64(c) for c in blob_chunks(blob, chunk_bytes)],
    }


def decode_span_payload(payload: dict) -> Dict[str, PageArray]:
    """Rebuild the per-field page arrays from an ``encode_span_payload``
    body. Raises ValueError when the chunks disagree with the manifest
    (truncated/duplicated chunk) or spans gap/overlap — a bad fetch must
    degrade to cold prefill, never inject garbage KV."""
    blob = b"".join(chunk_unb64(c) for c in payload.get("chunks", ()))
    snap = decode_snapshot({"arrays": payload.get("arrays", ())}, blob)
    return assemble_spans(snap["pages"], int(payload.get("from_page", 0)))
