"""Fault-tolerant checkpoints of the training state (counterpart of
``repro/checkpoint/checkpoint.py``, on the same on-disk protocol).

A step directory holds ``manifest.json`` (``step``, ``extra``, ``arrays``:
kind, dtype and shape of every leaf, and ``digests``: the sha256 of every
shard file), one ``shard_0.msgpack.zlib`` and a ``COMMIT`` marker:

 * atomic: written to ``step_N.tmp``, renamed to ``step_N``, then
   ``COMMIT`` is written last; restore only considers committed steps.
   Re-saving a committed step is a no-op; a renamed but uncommitted
   leftover is removed first.
 * integrity: ``load_checkpoint`` checks each shard against its digest
   and each entry's bytes against the manifest.  A damaged step is
   quarantined (``quarantine_step_N``, a ``checkpoint_corrupt`` event) and
   restore falls back through the older committed steps, unless a step
   was asked for.  Template drift (a leaf missing, another dtype or
   shape) raises ``CheckpointError`` and is not a fallback: an older step
   would be equally incompatible.
 * async: ``CheckpointManager.save_async`` copies the state to the host
   and writes it on a thread; ``wait()`` (which the next ``save_async``
   calls first) re-raises a failed save.  Keep-last-k GC.

The payload is the JAX package's msgpack layout, ``{key: [bytes, dtype,
shape]}``, keys like ``params/layers/#3/ffn/w_up`` or ``opt/m/.../q``,
written by a hand-written encoder for exactly that subset of msgpack (the
card's host has no ``msgpack``), into a zlib stream at level 0 (stored
blocks): zlib saves about 7% on weights at 18 MB/s, where stored blocks
run at about 500 MB/s and stay a valid stream for the JAX reader.  Each
leaf goes through the encoder, zlib and sha256 in 16 MiB pieces, so the
host holds one copy of the state; restore streams the file the same way.
bf16 travels as its 16 bits under the dtype name ``"bfloat16"``, as JAX
writes it.  A zstd shard (a JAX host with ``zstandard``) raises
``CheckpointError``: the port reads zlib only.

Over a (data, model) mesh the arrays saved are logical (full): every
leaf the tree's ``specs`` split (runtime/params.py:
``train_state_specs``, params and moments, an int8 moment's ``q`` and
``scale`` by the JAX package's ``moment_specs``) is gathered over ``data`` then
``model`` on every rank (``convert.gather_params``' rule), rank 0
writes, and the ranks then agree that the write succeeded (an all-reduce
of a failure flag, which is also the barrier).  On restore every rank
reads the same files and cuts its part by the specs of the mesh it runs
on (``convert.shard_params``' rule), so a checkpoint restores on another
mesh, on one card, or in the JAX package, with the same padded expert
count; another ``E_pad`` is template drift.  Over a mesh of more than
one rank the specs are required (the ``dp_only`` profile's cut over
``data`` only); ``specs=None`` is for one rank.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import collectives
from repro_torch.obs import events as obs_events
from repro_torch.runtime import params as params_lib
from repro_torch.runtime import sharding

ZLIB_LEVEL = 0
_CHUNK = 16 << 20
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_KEY_SEP = "/"

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}


class CheckpointError(RuntimeError):
    """Checkpoint / template incompatibility or a failed save."""


class CheckpointCorruptError(CheckpointError):
    """On-disk damage (digest mismatch, truncated, missing or undecodable
    shard): ``load_checkpoint`` quarantines the step and falls back."""


# ------------------------------------------------- the msgpack subset --
# map of str keys to arrays of [bin, str, [int, ...]]: what
# msgpack.packb(payload, use_bin_type=True) writes for the JAX payload.

def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              fmts: Tuple[str, ...]) -> bytes:
    if fix >= 0 and n <= fix_max:
        return bytes([fix | n])
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_map(n: int) -> bytes:
    return _pack_len(n, 0x80, 15, (0xDE, 0xDF), (">H", ">I"))


def _pack_array(n: int) -> bytes:
    return _pack_len(n, 0x90, 15, (0xDC, 0xDD), (">H", ">I"))


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB),
                     (">B", ">H", ">I")) + b


def _pack_bin_header(n: int) -> bytes:
    return _pack_len(n, -1, -1, (0xC4, 0xC5, 0xC6), (">B", ">H", ">I"))


def _pack_int(i: int) -> bytes:
    i = int(i)
    if 0 <= i <= 0x7F:
        return bytes([i])
    if -32 <= i < 0:
        return struct.pack(">b", i)
    if i >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                          (0xCF, ">Q")):
            if i < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, i)
    for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                      (0xD3, ">q")):
        lim = 1 << (8 * struct.calcsize(fmt) - 1)
        if -lim <= i:
            return bytes([code]) + struct.pack(fmt, i)
    raise ValueError(f"int {i} does not fit msgpack")


def _entry_head(key: str, nbytes: int) -> bytes:
    """Everything of one map entry that comes before its array bytes."""
    return _pack_str(key) + _pack_array(3) + _pack_bin_header(nbytes)


def _entry_tail(dtype: str, shape) -> bytes:
    return _pack_str(dtype) + _pack_array(len(shape)) + b"".join(
        _pack_int(d) for d in shape)


def _byte_view(a: np.ndarray) -> memoryview:
    return memoryview(np.asarray(a, order="C").reshape(-1).view(np.uint8))


def packb(payload: Dict[str, Tuple[Any, str, List[int]]]) -> bytes:
    """The bytes ``msgpack.packb(payload, use_bin_type=True)`` gives for a
    payload of ``{key: (bytes or uint8 array, dtype, shape)}``."""
    out = [_pack_map(len(payload))]
    for key, (buf, dtype, shape) in payload.items():
        mv = memoryview(buf).cast("B")
        out += [_entry_head(key, len(mv)), bytes(mv),
                _entry_tail(dtype, shape)]
    return b"".join(out)


class _Source:
    """Reads the decoded bytes of a shard: from memory, or from a file
    through zlib while hashing the file's bytes."""

    def __init__(self, data: Optional[bytes] = None, f=None):
        self._f = f
        self._buf = memoryview(data if data is not None else b"")
        self._pos = 0
        self.sha = hashlib.sha256()
        self._z = self._head = None
        if f is not None:
            self._head = f.read(_CHUNK)
            self.sha.update(self._head)
            if self._head[:4] == _ZSTD_MAGIC:
                raise CheckpointError(
                    "checkpoint shard is zstd-compressed; the port reads "
                    "zlib shards only (the card's host has no zstandard): "
                    "re-save it on a host without zstandard")
            self._z = zlib.decompressobj()

    def _more(self) -> None:
        if self._z is None:
            raise ValueError("msgpack data ends early")
        while True:
            data = self._z.unconsumed_tail
            if self._head is not None:
                data, self._head = self._head, None
            elif not data:
                if self._z.eof:
                    raise ValueError("zlib stream ends before the payload")
                data = self._f.read(_CHUNK)
                if not data:
                    raise ValueError("shard ends before its zlib stream")
                self.sha.update(data)
            out = self._z.decompress(data, _CHUNK)
            if out:
                self._buf, self._pos = memoryview(out), 0
                return

    def readinto(self, dst: memoryview) -> None:
        n = 0
        while n < len(dst):
            if self._pos == len(self._buf):
                self._more()
            k = min(len(self._buf) - self._pos, len(dst) - n)
            dst[n:n + k] = self._buf[self._pos:self._pos + k]
            n += k
            self._pos += k

    def read(self, n: int) -> bytes:
        b = bytearray(n)
        self.readinto(memoryview(b))
        return bytes(b)

    def finish(self) -> None:
        """Hash the rest of the file; raise if decoded bytes are left
        over or the zlib stream does not end there (trailing garbage)."""
        if self._f is None:
            if self._pos != len(self._buf):
                raise ValueError("extra bytes after the msgpack data")
            return
        while True:
            data = self._f.read(_CHUNK)
            if not data:
                break
            self.sha.update(data)
            if self._z is not None:
                self._z.decompress(data)
        if self._z is not None and (self._pos != len(self._buf)
                                    or self._head or not self._z.eof
                                    or self._z.unconsumed_tail
                                    or self._z.unused_data):
            raise ValueError("bytes after the payload in the zlib stream")

    def drain_hash(self) -> str:
        if self._f is not None:
            while True:
                data = self._f.read(_CHUNK)
                if not data:
                    break
                self.sha.update(data)
        return self.sha.hexdigest()


def _unpack(src: _Source, bin_as_bytes: bool):
    b = src.read(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _unpack_map(src, b & 0x0F, bin_as_bytes)
    if 0x90 <= b <= 0x9F:
        return [_unpack(src, bin_as_bytes) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return src.read(b & 0x1F).decode("utf-8")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        fmt = ints[b]
        return struct.unpack(fmt, src.read(struct.calcsize(fmt)))[0]
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if b not in lens:
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                         "checkpoint's subset")
    fmt = lens[b]
    n = struct.unpack(fmt, src.read(struct.calcsize(fmt)))[0]
    if b in (0xC4, 0xC5, 0xC6):
        if bin_as_bytes:
            return src.read(n)
        buf = np.empty(n, np.uint8)
        src.readinto(memoryview(buf))
        return buf
    if b in (0xD9, 0xDA, 0xDB):
        return src.read(n).decode("utf-8")
    if b in (0xDC, 0xDD):
        return [_unpack(src, bin_as_bytes) for _ in range(n)]
    return _unpack_map(src, n, bin_as_bytes)


def _unpack_map(src: _Source, n: int, bin_as_bytes: bool) -> Dict:
    out = {}
    for _ in range(n):
        k = _unpack(src, bin_as_bytes)
        out[k] = _unpack(src, bin_as_bytes)
    return out


def unpackb(data: bytes) -> Any:
    """Decode msgpack bytes of the checkpoint's subset (bins as bytes,
    arrays as lists), as ``msgpack.unpackb(data, raw=False)`` does."""
    src = _Source(data)
    obj = _unpack(src, True)
    src.finish()
    return obj


# ------------------------------------------------------ tree <-> keys --

def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) of every non-None leaf, keys as the JAX package names
    them (dict key, ``#i`` for a list entry, the field name of a
    NamedTuple)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return [(prefix[:-len(_KEY_SEP)], tree)]
    return [x for k, v in items
            for x in _flatten(v, f"{prefix}{k}{_KEY_SEP}")]


def _unflatten(template: Any, values: Dict[str, Any], prefix: str = ""):
    if template is None:
        return None
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten(getattr(template, f), values,
                       f"{prefix}{f}{_KEY_SEP}") for f in template._fields])
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}{_KEY_SEP}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, values, f"{prefix}#{i}{_KEY_SEP}")
                for i, v in enumerate(template)]
    return values[prefix[:-len(_KEY_SEP)]]


def dtype_name(t: torch.Tensor) -> str:
    return _DTYPE_NAMES[t.dtype]


def _host_array(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a host numpy array (bf16 as int16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    # a copy also on the CPU: the step updates the state in place while
    # the save thread writes it
    return t.to("cpu", copy=True).contiguous().numpy()


def _sync_device(tree) -> torch.device:
    """A device the mesh's backend moves: a CUDA leaf's if there is one."""
    for _, leaf in _flatten(tree):
        if leaf.device.type == "cuda":
            return leaf.device
    return torch.device("cpu")


def _is_rank0(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _agree(failed: bool, mesh, device: torch.device) -> bool:
    """True when some rank failed; the all-reduce is the ranks' barrier."""
    return collectives.any_rank(failed, sharding.world_group(mesh), device)


HostEntry = Tuple[str, np.ndarray, str, List[int]]


def _split_specs(specs, mesh) -> Dict[str, Any]:
    """{key: spec} of the leaves ``specs`` split over ``mesh``."""
    if specs is None:
        if sharding.num_ranks(mesh) > 1:
            raise ValueError(
                "a checkpoint over a mesh of more than one rank needs the "
                "state's specs (runtime/params.train_state_specs)")
        return {}
    return {k: s for k, s in params_lib.flat_specs(specs).items()
            if params_lib.split_axes(s, mesh)}


def host_copy(tree, mesh=None, specs=None) -> Optional[List[HostEntry]]:
    """(key, host bytes, dtype, logical shape) of every leaf, the leaves
    ``specs`` split gathered over the mesh leaf by leaf (a collective:
    every rank calls it); None on ranks other than 0, which write
    nothing."""
    out: Optional[List[HostEntry]] = [] if _is_rank0(mesh) else None
    split = _split_specs(specs, mesh)
    for key, leaf in _flatten(tree):
        if key in split:
            leaf = params_lib.gather(leaf, split[key], mesh)
        if out is not None:
            out.append((key, _host_array(leaf), dtype_name(leaf),
                        list(leaf.shape)))
    return out


# ----------------------------------------------------------- save --

def _write_shard(path: str, entries: List[HostEntry]) -> str:
    """Stream the payload through the encoder, zlib and sha256 into
    ``path``; returns the digest of the bytes on disk."""
    comp = zlib.compressobj(ZLIB_LEVEL)
    sha = hashlib.sha256()
    with open(path, "wb") as f:
        def put(b):
            if b:
                f.write(b)
                sha.update(b)
        put(comp.compress(_pack_map(len(entries))))
        for key, arr, dtype, shape in entries:
            mv = _byte_view(arr)
            put(comp.compress(_entry_head(key, len(mv))))
            for off in range(0, len(mv), _CHUNK):
                put(comp.compress(mv[off:off + _CHUNK]))
            put(comp.compress(_entry_tail(dtype, shape)))
        put(comp.flush())
        f.flush()
        os.fsync(f.fileno())
    return sha.hexdigest()


def write_checkpoint(directory: str, step: int, entries: List[HostEntry],
                     *, extra: Optional[Dict] = None) -> str:
    """The file protocol of one save, from a host copy (rank 0's part of
    ``save_checkpoint``)."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(os.path.join(final, "COMMIT")):
        return final          # idempotent: already durable
    if os.path.exists(final):
        shutil.rmtree(final)  # renamed but never committed: a crash leftover
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shard = "shard_0.msgpack.zlib"
    manifest = {"step": step, "extra": extra or {}, "arrays": {
        key: {"kind": "array", "dtype": dtype, "shape": shape}
        for key, _, dtype, shape in entries}}
    manifest["digests"] = {shard: _write_shard(os.path.join(tmp, shard),
                                               entries)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.rename(tmp, final)
    with open(os.path.join(final, "COMMIT"), "w") as f:
        f.write("ok")
    obs_events.emit("checkpoint_save", step=step, path=final)
    return final


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: Optional[Dict] = None, mesh=None,
                    specs=None) -> str:
    """Synchronous save of ``tree`` (a collective over the mesh; ``specs``
    the tree's spec tree, module docstring)."""
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(os.path.join(final, "COMMIT")):
        return final
    entries = host_copy(tree, mesh, specs)
    err = None
    if entries is not None:
        try:
            write_checkpoint(directory, step, entries, extra=extra)
        except Exception as e:
            err = e
    if _agree(err is not None, mesh, _sync_device(tree)):
        raise CheckpointError(f"save of step {step} failed"
                              + (f": {err!r}" if err else " on rank 0"))
    return final


def committed_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            s = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if os.path.exists(os.path.join(directory, name, "COMMIT")):
            steps.append(s)
    return sorted(steps)


# -------------------------------------------------------- restore --

def _read_manifest(path: str) -> Dict:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable manifest ({e})") from e
    if not isinstance(manifest, dict) or "arrays" not in manifest:
        raise CheckpointCorruptError(f"{path}: malformed manifest")
    return manifest


def _read_shard(path: str, name: str, want: Optional[str]) -> Dict:
    """Decode one shard while hashing it; a digest mismatch is reported
    as such even where decoding failed first."""
    with open(os.path.join(path, name), "rb") as f:
        src = _Source(f=f)
        try:
            payload = _unpack(src, False)
            src.finish()
            err = None if isinstance(payload, dict) else ValueError(
                "payload is not a map")
        except (ValueError, zlib.error, UnicodeDecodeError,
                struct.error) as e:
            payload, err = None, e
        got = src.drain_hash()
    if want is not None and got != want:
        raise CheckpointCorruptError(
            f"{path}: sha256 mismatch for {name} (manifest {want[:12]}…, "
            f"on disk {got[:12]}…)")
    if err is not None:
        raise CheckpointCorruptError(
            f"{path}: shard {name} undecodable ({err!r})") from err
    return payload


def read_checkpoint(path: str
                    ) -> Tuple[Dict, Dict[str, Tuple[np.ndarray, str]]]:
    """(manifest, {key: (array, dtype name)}) of one committed step
    directory, every shard checked against its digest and every entry
    against the manifest.  Raises CheckpointCorruptError for damage."""
    manifest = _read_manifest(path)
    digests = manifest.get("digests") or {}
    names = sorted(n for n in os.listdir(path) if n.startswith("shard_"))
    for name in digests:
        if name not in names:
            raise CheckpointCorruptError(
                f"{path}: shard {name} named in the manifest digests is "
                "missing (COMMIT present: a partial or deleted shard)")
    if not names:
        raise CheckpointCorruptError(f"{path}: no shard files")
    payload: Dict = {}
    for name in names:
        payload.update(_read_shard(path, name, digests.get(name)))
    arrays: Dict[str, Tuple[np.ndarray, str]] = {}
    for key, info in manifest["arrays"].items():
        if info.get("kind") == "none":
            continue
        if key not in payload:
            raise CheckpointCorruptError(
                f"{path}: manifest lists {key!r} but no shard holds it "
                "(missing shard data with COMMIT present)")
        try:
            buf, dtype, shape = payload[key]
        except (TypeError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: shard entry {key!r} is malformed") from e
        if (info.get("dtype"), list(info.get("shape", ()))) != \
                (dtype, list(shape)):
            raise CheckpointCorruptError(
                f"{path}: shard entry {key!r} disagrees with the manifest "
                f"({dtype}{list(shape)} vs {info.get('dtype')}"
                f"{info.get('shape')})")
        np_dtype = np.dtype(np.int16 if dtype == "bfloat16" else dtype)
        want = np_dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if len(buf) != want:
            raise CheckpointCorruptError(
                f"{path}: shard entry {key!r} holds {len(buf)} bytes, "
                f"expected {want} (truncated shard)")
        arrays[key] = (np.frombuffer(buf, np_dtype).reshape(shape), dtype)
    return manifest, arrays


def _restore_from(path: str, template, mesh, specs,
                  remap: Optional[Callable]) -> Tuple[Any, Dict]:
    """Verified restore of one committed step directory into
    ``template``'s structure, devices and (over a mesh) this rank's
    parts.  CheckpointCorruptError for on-disk damage, CheckpointError
    for incompatibility."""
    manifest, arrays = read_checkpoint(path)
    if remap is not None:
        arrays = remap(arrays)
    split = _split_specs(specs, mesh)
    values = {}
    for key, tpl in _flatten(template):
        if key not in arrays:
            raise CheckpointError(
                f"{path}: checkpoint has no entry for template leaf "
                f"{key!r}: template / checkpoint structure mismatch")
        arr, dtype = arrays[key]
        want = list(params_lib.logical_shape(tpl.shape, split[key], mesh)
                    if key in split else tpl.shape)
        if dtype_name(tpl) != dtype or want != list(arr.shape):
            raise CheckpointError(
                f"{path}: leaf {key!r} is {dtype}{list(arr.shape)} in the "
                f"checkpoint but {dtype_name(tpl)}{want} in the template: "
                "config / arch (or padded expert count) drift between save "
                "and restore")
        t = torch.from_numpy(np.asarray(arr, order="C"))
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        if key in split:
            t = params_lib.shard(t, split[key], mesh).contiguous()
        values[key] = t.to(tpl.device)
    return _unflatten(template, values), manifest.get("extra", {})


def quarantine_step(directory: str, step: int, reason: str) -> str:
    """Move a damaged committed step out of restore's and GC's sight,
    keeping its bytes; emits ``checkpoint_corrupt``."""
    src = os.path.join(directory, f"step_{step}")
    dst = os.path.join(directory, f"quarantine_step_{step}")
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(directory, f"quarantine_step_{step}.{n}")
    os.rename(src, dst)
    obs_events.emit("checkpoint_corrupt", step=step, path=src,
                    quarantined=dst, reason=reason)
    return dst


def load_checkpoint(directory: str, template, *, step: Optional[int] = None,
                    fallback: bool = True, mesh=None, specs=None,
                    remap: Optional[Callable] = None):
    """Restore into ``template``'s structure -> (tree, step, extra).  A
    corrupt newest step is quarantined and restore falls back to the next
    older committed one, unless ``fallback=False`` or ``step`` was asked
    for; then the corruption raises.  Over a mesh every rank reads the
    files, the ranks agree on whether a step is damaged, and rank 0
    quarantines it.  ``remap`` maps the checkpoint's {key: (array,
    dtype)} to the template's keys (a JAX-written layout: convert.py)."""
    steps = committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    explicit = step is not None
    if explicit and step not in steps:
        raise FileNotFoundError(
            f"step {step} is not a committed checkpoint in {directory} "
            f"(committed: {steps})")
    dev = _sync_device(template)
    failures = []
    for s in ([step] if explicit else list(reversed(steps))):
        path = os.path.join(directory, f"step_{s}")
        err = None
        try:
            tree, extra = _restore_from(path, template, mesh, specs, remap)
        except CheckpointCorruptError as e:
            err = e
        if not _agree(err is not None, mesh, dev):
            obs_events.emit("checkpoint_restore", step=s, path=path)
            return tree, s, extra
        reason = str(err) if err is not None else \
            f"{path}: damaged on another rank"
        if explicit or not fallback:
            raise err if err is not None else CheckpointCorruptError(reason)
        if _is_rank0(mesh):
            quarantine_step(directory, s, reason)
        _agree(False, mesh, dev)          # the rename is seen by every rank
        failures.append(reason)
    raise CheckpointCorruptError(
        f"every committed checkpoint in {directory} is corrupt "
        f"({len(failures)} quarantined): " + "; ".join(failures))


class CheckpointManager:
    """Async double-buffered saves and keep-last-k GC.

    ``save_async`` waits for the previous save, copies the state to the
    host (the only synchronous part; the split leaves gathered over the
    mesh), and writes it on a thread on rank 0.  A failed save is emitted
    as ``checkpoint_error`` and re-raised as CheckpointError from
    ``wait()``, once; over a mesh every rank raises it (``wait`` is a
    collective).  ``last_host_copy_s`` / ``last_write_s`` /
    ``last_bytes`` describe the latest save."""

    def __init__(self, directory: str, keep: int = 3, *, mesh=None,
                 specs=None):
        self.directory = directory
        self.keep = keep
        _split_specs(specs, mesh)             # raises where they are missing
        self.mesh = mesh
        self.specs = specs
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_step: Optional[int] = None
        # the device of the save not yet confirmed by wait() (None: none);
        # every rank issues the same saves, so all agree on when to meet
        self._device: Optional[torch.device] = None
        self.last_host_copy_s = self.last_write_s = 0.0
        self.last_bytes = 0

    def save_async(self, step: int, tree, extra: Optional[Dict] = None):
        self.wait()
        self._device = _sync_device(tree)
        t0 = time.perf_counter()
        entries = host_copy(tree, self.mesh, self.specs)
        self.last_host_copy_s = time.perf_counter() - t0
        if entries is None:
            return

        def work():
            t1 = time.perf_counter()
            try:
                final = write_checkpoint(self.directory, step, entries,
                                         extra=extra)
                self.last_bytes = sum(
                    os.path.getsize(os.path.join(final, n))
                    for n in os.listdir(final))
                self._gc()
            except BaseException as e:
                self._error, self._error_step = e, step
                obs_events.emit("checkpoint_error", step=step,
                                directory=self.directory, error=repr(e))
            self.last_write_s = time.perf_counter() - t1

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    @property
    def in_flight(self) -> bool:
        """A save is still being written."""
        return self._pending is not None and self._pending.is_alive()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._device is None:
            return
        dev, self._device = self._device, None
        e, s = self._error, self._error_step
        self._error = self._error_step = None
        if _agree(e is not None, self.mesh, dev):
            raise CheckpointError(
                f"async checkpoint save of step {s} failed: {e!r}"
                if e is not None else
                "async checkpoint save failed on rank 0") from e

    def _gc(self):
        for s in committed_steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = committed_steps(self.directory)
        return steps[-1] if steps else None
