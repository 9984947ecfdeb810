"""Dependency-free LMDB file IO (read + fresh-file write).

The port's own copy of :mod:`adsorbdiff_tpu.data.lmdbio`: the reference's
datasets are single-file LMDB environments of pickled graphs (opened with
``subdir=False, readonly=True, lock=False``), and neither the ``lmdb``
package nor liblmdb is needed to read or write them.  This module implements
the public LMDB data format v1 directly:

- :class:`LmdbReader`: read-only B+tree walker over an mmap'd single-file
  environment: meta-page selection by txnid, page-size detection,
  branch/leaf traversal, BIGDATA overflow chains.
- :class:`LmdbWriter` / :func:`write_lmdb`: a fresh single-transaction
  environment (sorted keys, packed leaves, as many branch levels as the
  entry count needs, overflow pages for large values); the bytes are the
  JAX package's for the same items.

Layout facts used below (64-bit, little-endian, 4096-byte pages by default,
the format liblmdb documents in lmdb.h/mdb.c):

- page header (16 B): pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
  (for OVERFLOW pages the lower/upper union holds a u32 page count);
- flags: BRANCH=0x01 LEAF=0x02 OVERFLOW=0x04 META=0x08;
- node (8 B header): lo u16 | hi u16 | flags u16 | ksize u16 | key | data,
  leaf data size = lo | hi<<16; node flag BIGDATA=0x01 replaces inline data
  with a u64 overflow pgno; branch child pgno = lo | hi<<16 | flags<<32;
- sorted 2-byte node-offset array starts at byte 16; nodes fill from the
  page end downward (lower/upper track the gap);
- meta (at byte 16 of pages 0 and 1): magic 0xBEEFC0DE u32 | version=1 u32 |
  address u64 | mapsize u64 | two MDB_db (pad u32, flags u16, depth u16,
  branch/leaf/overflow pages u64 x3, entries u64, root u64) for the free and
  main DBs | last_pg u64 | txnid u64; the live meta is the one with the
  larger txnid; empty root = 0xFFFF_FFFF_FFFF_FFFF.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

PAGE_HDR = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MAGIC = 0xBEEFC0DE
VERSION = 1
INVALID_PGNO = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch, leaf, ovf, entries, root
_PAGE = struct.Struct("<QHHHH")  # pgno, pad, flags, lower, upper
_NODE = struct.Struct("<HHHH")  # lo, hi, flags, ksize


class LmdbFormatError(ValueError):
    pass


class LmdbReader:
    """Read-only single-file LMDB environment (the reference's
    ``lmdb.open(path, subdir=False, readonly=True)`` shape)."""

    backend = "python"  # what :func:`~adsorbdiff_tpu_torch.data.lmdb_native.open_best_reader` took

    def __init__(self, path: str) -> None:
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.psize = self._detect_page_size()
        meta0 = self._read_meta(0)
        meta1 = self._read_meta(1)
        metas = [m for m in (meta0, meta1) if m is not None]
        if not metas:
            raise LmdbFormatError(f"{path}: no valid LMDB meta page")
        self.meta = max(metas, key=lambda m: m["txnid"])
        self.entries = self.meta["main"]["entries"]
        self.root = self.meta["main"]["root"]

    def _detect_page_size(self) -> int:
        # liblmdb stores the page size in the free-DB md_pad field of the meta
        # page (mdb.c: mm_psize = mm_dbs[FREE_DBI].md_pad); prefer it, and only
        # fall back to stride-probing for files that leave that field 0.
        if len(self._mm) >= PAGE_HDR + _META.size + 4:
            _, _, flags, _, _ = _PAGE.unpack_from(self._mm, 0)
            magic, version, _, _ = _META.unpack_from(self._mm, PAGE_HDR)
            (md_pad,) = struct.unpack_from("<I", self._mm, PAGE_HDR + _META.size)
            if (
                flags & P_META
                and magic == MAGIC
                and version == VERSION
                and 512 <= md_pad <= 65536
                and md_pad & (md_pad - 1) == 0
                and len(self._mm) >= 2 * md_pad
            ):
                return md_pad
        # probe common sizes by checking that page 1 at that stride is also a
        # META page
        for ps in (4096, 8192, 16384, 32768, 65536, 512, 1024, 2048):
            if len(self._mm) < 2 * ps:
                continue
            ok = True
            for pg in (0, 1):
                base = pg * ps
                _, _, flags, _, _ = _PAGE.unpack_from(self._mm, base)
                magic, version, _, _ = _META.unpack_from(self._mm, base + PAGE_HDR)
                if not (flags & P_META and magic == MAGIC and version == VERSION):
                    ok = False
                    break
            if ok:
                return ps
        raise LmdbFormatError("could not detect LMDB page size (not an LMDB file?)")

    def _read_meta(self, pg: int) -> Optional[dict]:
        base = pg * self.psize
        magic, version, _, mapsize = _META.unpack_from(self._mm, base + PAGE_HDR)
        if magic != MAGIC or version != VERSION:
            return None
        off = base + PAGE_HDR + _META.size
        dbs = []
        for _ in range(2):
            pad, flags, depth, br, lf, ovf, entries, root = _DB.unpack_from(self._mm, off)
            dbs.append({"flags": flags, "depth": depth, "entries": entries, "root": root})
            off += _DB.size
        last_pg, txnid = struct.unpack_from("<QQ", self._mm, off)
        return {"free": dbs[0], "main": dbs[1], "last_pg": last_pg, "txnid": txnid}

    # ------------------------------------------------------------- traversal
    def _page(self, pgno: int) -> Tuple[int, int, List[int]]:
        base = pgno * self.psize
        _, _, flags, lower, upper = _PAGE.unpack_from(self._mm, base)
        n = (lower - PAGE_HDR) // 2
        ptrs = list(struct.unpack_from(f"<{n}H", self._mm, base + PAGE_HDR)) if n else []
        return base, flags, ptrs

    def _node(self, base: int, off: int) -> Tuple[bytes, int, int, int]:
        lo, hi, flags, ksize = _NODE.unpack_from(self._mm, base + off)
        kstart = base + off + _NODE.size
        key = bytes(self._mm[kstart : kstart + ksize])
        return key, lo | (hi << 16) | (flags << 32), flags, kstart + ksize

    def _leaf_value(self, base: int, off: int) -> bytes:
        lo, hi, flags, ksize = _NODE.unpack_from(self._mm, base + off)
        dsize = lo | (hi << 16)
        dstart = base + off + _NODE.size + ksize
        if flags & F_BIGDATA:
            (ovf_pgno,) = struct.unpack_from("<Q", self._mm, dstart)
            obase = ovf_pgno * self.psize
            return bytes(self._mm[obase + PAGE_HDR : obase + PAGE_HDR + dsize])
        return bytes(self._mm[dstart : dstart + dsize])

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order."""
        if self.root == INVALID_PGNO:
            return
        stack = [self.root]
        while stack:
            pgno = stack.pop()
            base, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                children = []
                for off in ptrs:
                    _, child, _, _ = self._node(base, off)
                    children.append(child & 0xFFFFFFFFFFFF)
                stack.extend(reversed(children))  # keep key order
            elif flags & P_LEAF:
                for off in ptrs:
                    lo, hi, nflags, ksize = _NODE.unpack_from(self._mm, base + off)
                    kstart = base + off + _NODE.size
                    key = bytes(self._mm[kstart : kstart + ksize])
                    yield key, self._leaf_value(base, off)
            else:
                raise LmdbFormatError(f"unexpected page flags {flags:#x} at pgno {pgno}")

    def keys(self) -> Iterator[bytes]:
        """All keys in key order, without touching value bytes — lets callers
        stream multi-GB shards (sort the small key list, then `get` each value
        as it is consumed) instead of buffering every record."""
        if self.root == INVALID_PGNO:
            return
        stack = [self.root]
        while stack:
            pgno = stack.pop()
            base, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                children = []
                for off in ptrs:
                    _, child, _, _ = self._node(base, off)
                    children.append(child & 0xFFFFFFFFFFFF)
                stack.extend(reversed(children))
            elif flags & P_LEAF:
                for off in ptrs:
                    _, _, _, ksize = _NODE.unpack_from(self._mm, base + off)
                    kstart = base + off + _NODE.size
                    yield bytes(self._mm[kstart : kstart + ksize])
            else:
                raise LmdbFormatError(f"unexpected page flags {flags:#x} at pgno {pgno}")

    def get(self, key: bytes) -> Optional[bytes]:
        """Point lookup via B+tree descent."""
        if self.root == INVALID_PGNO:
            return None
        pgno = self.root
        while True:
            base, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                # child 0 has an empty key; descend into the rightmost child
                # whose key <= target
                child = None
                for i, off in enumerate(ptrs):
                    k, pg, _, _ = self._node(base, off)
                    if i == 0 or k <= key:
                        child = pg & 0xFFFFFFFFFFFF
                    else:
                        break
                pgno = child
            elif flags & P_LEAF:
                for off in ptrs:
                    lo, hi, nflags, ksize = _NODE.unpack_from(self._mm, base + off)
                    kstart = base + off + _NODE.size
                    if bytes(self._mm[kstart : kstart + ksize]) == key:
                        return self._leaf_value(base, off)
                return None
            else:
                raise LmdbFormatError(f"unexpected page flags {flags:#x}")

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class LmdbWriter:
    """Write a fresh single-file LMDB environment in one shot.

    Produces the exact on-disk shape a single liblmdb write transaction on a
    new environment would: pages 0/1 meta, data pages from 2 up, a main-DB
    B+tree with as many branch levels as the entry count needs (OC20 shards
    run to ~10^6 records), BIGDATA overflow chains for values that don't fit
    a half-page node.
    """

    def __init__(self, path: str, psize: int = 4096) -> None:
        self.path = path
        self.psize = psize
        self._items: List[Tuple[bytes, bytes]] = []

    def put(self, key: bytes, value: bytes) -> None:
        self._items.append((bytes(key), bytes(value)))

    # liblmdb: a node must fit in half a page (MINKEYS=2) or go to overflow
    def _node_max(self) -> int:
        return ((self.psize - PAGE_HDR) // 2) & ~1

    def _pack_node(self, key: bytes, dsize: int, flags: int, payload: bytes) -> bytes:
        node = _NODE.pack(dsize & 0xFFFF, (dsize >> 16) & 0xFFFF, flags, len(key)) + key + payload
        return node + (b"\x00" if len(node) & 1 else b"")  # even alignment

    def _pack_branch_node(self, key: bytes, child_pgno: int) -> bytes:
        node = _NODE.pack(
            child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF, (child_pgno >> 32) & 0xFFFF, len(key)
        ) + key
        return node + (b"\x00" if len(node) & 1 else b"")

    def _emit_page(self, pgno: int, flags: int, nodes: List[bytes]) -> bytes:
        body_len = sum(len(n) for n in nodes)
        lower = PAGE_HDR + 2 * len(nodes)
        upper = self.psize - body_len
        assert lower <= upper, "page overflow (writer bug)"
        page = bytearray(self.psize)
        _PAGE.pack_into(page, 0, pgno, 0, flags, lower, upper)
        # nodes pack downward from the page end, ptrs stay in key order
        off = self.psize
        offsets = []
        for n in nodes:
            off -= len(n)
            page[off : off + len(n)] = n
            offsets.append(off)
        struct.pack_into(f"<{len(nodes)}H", page, PAGE_HDR, *offsets)
        return bytes(page)

    def _meta_page(self, pgno: int, txnid: int, main: dict, last_pg: int) -> bytes:
        page = bytearray(self.psize)
        _PAGE.pack_into(page, 0, pgno, 0, P_META, 0, 0)
        _META.pack_into(page, PAGE_HDR, MAGIC, VERSION, 0, self.psize * (last_pg + 64))
        off = PAGE_HDR + _META.size
        # liblmdb stores the environment page size in the free-DB md_pad slot
        # (mdb.c: `#define mm_psize mm_dbs[FREE_DBI].md_pad`) and reads
        # me_psize from it on open: a zero here makes real liblmdb reject the
        # file.
        _DB.pack_into(page, off, self.psize, 0, 0, 0, 0, 0, 0, INVALID_PGNO)  # free DB, empty
        off += _DB.size
        _DB.pack_into(
            page, off, 0, main["flags"], main["depth"], main["branch"], main["leaf"],
            main["ovf"], main["entries"], main["root"],
        )
        off += _DB.size
        struct.pack_into("<QQ", page, off, last_pg, txnid)
        return bytes(page)

    def close(self) -> None:
        items = sorted(self._items)  # memcmp key order
        node_max = self._node_max()
        next_pg = 2
        data_pages: List[Tuple[int, bytes]] = []  # (pgno, raw)
        ovf_count = 0

        # 1) materialize leaf nodes, spilling big values to overflow chains
        leaf_nodes: List[Tuple[bytes, bytes]] = []  # (key, packed node)
        ovf_pages: List[Tuple[int, bytes]] = []
        for key, value in items:
            inline = _NODE.size + len(key) + len(value)
            if inline > node_max:
                npages = -(-(len(value) + PAGE_HDR) // self.psize)
                raw = bytearray(npages * self.psize)
                _PAGE.pack_into(raw, 0, next_pg, 0, P_OVERFLOW, 0, 0)
                struct.pack_into("<I", raw, 12, npages)  # lower/upper union
                raw[PAGE_HDR : PAGE_HDR + len(value)] = value
                for i in range(npages):
                    ovf_pages.append((next_pg + i, bytes(raw[i * self.psize : (i + 1) * self.psize])))
                node = self._pack_node(key, len(value), F_BIGDATA, struct.pack("<Q", next_pg))
                next_pg += npages
                ovf_count += npages
            else:
                node = self._pack_node(key, len(value), 0, value)
            leaf_nodes.append((key, node))

        # 2) pack leaves
        leaves: List[Tuple[int, List[Tuple[bytes, bytes]]]] = []
        cur: List[Tuple[bytes, bytes]] = []
        cur_size = 0
        for key, node in leaf_nodes:
            if cur and PAGE_HDR + 2 * (len(cur) + 1) + cur_size + len(node) > self.psize:
                leaves.append((next_pg, cur))
                next_pg += 1
                cur, cur_size = [], 0
            cur.append((key, node))
            cur_size += len(node)
        if cur or not leaves:
            leaves.append((next_pg, cur))
            next_pg += 1
        for pgno, nodes in leaves:
            data_pages.append((pgno, self._emit_page(pgno, P_LEAF, [n for _, n in nodes])))

        # 3) branch levels until a single root (first key of the leftmost
        # node at every level is empty, as liblmdb writes them)
        n_branch = 0
        depth = 1
        level = [(pgno, nodes[0][0] if nodes else b"") for pgno, nodes in leaves]
        while len(level) > 1:
            next_level = []
            cur_nodes: List[bytes] = []
            cur_size = 0
            cur_first_key = None
            level_pages: List[Tuple[int, List[bytes], bytes]] = []
            for i, (child_pg, child_key) in enumerate(level):
                node = self._pack_branch_node(b"" if not cur_nodes else child_key, child_pg)
                if cur_nodes and PAGE_HDR + 2 * (len(cur_nodes) + 1) + cur_size + len(node) > self.psize:
                    level_pages.append((next_pg, cur_nodes, cur_first_key))
                    next_pg += 1
                    cur_nodes, cur_size = [], 0
                    node = self._pack_branch_node(b"", child_pg)  # leftmost of new page
                    cur_first_key = child_key
                if cur_first_key is None:
                    cur_first_key = child_key
                cur_nodes.append(node)
                cur_size += len(node)
            level_pages.append((next_pg, cur_nodes, cur_first_key))
            next_pg += 1
            for pgno, nodes, _ in level_pages:
                data_pages.append((pgno, self._emit_page(pgno, P_BRANCH, nodes)))
                n_branch += 1
            level = [(pgno, first_key) for pgno, _, first_key in level_pages]
            depth += 1
        root = level[0][0] if items else INVALID_PGNO

        main = {
            "flags": 0,
            "depth": depth if items else 0,
            "branch": n_branch,
            "leaf": len(leaves),
            "ovf": ovf_count,
            "entries": len(items),
            "root": root if items else INVALID_PGNO,
        }
        last_pg = next_pg - 1

        with open(self.path, "wb") as f:
            f.write(self._meta_page(0, 0, main, last_pg))
            f.write(self._meta_page(1, 1, main, last_pg))
            for _, raw in sorted(data_pages + ovf_pages):
                f.write(raw)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_lmdb(path: str, items: List[Tuple[bytes, bytes]], psize: int = 4096) -> None:
    """Convenience: write sorted (key, value) pairs as a fresh environment."""
    if os.path.exists(path):
        os.remove(path)
    with LmdbWriter(path, psize=psize) as w:
        for k, v in items:
            w.put(k, v)
