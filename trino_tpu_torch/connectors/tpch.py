"""TPC-H connector of the PyTorch port (counterpart of ``trino_tpu/connectors/tpch.py``).

Rows are pure functions of the global row index (a splitmix64 counter-based
RNG), so a table scan is a handful of elementwise torch ops that produce one
page per split directly on the engine's device: no host IO and no transfer.
Schemas, dictionaries, cardinalities and every formula are the reference's,
and each column comes out equal to the reference's, split by split.

Strings are dictionary-encoded (int32 ids on the device, dictionaries on the
host); per-row-unique strings use the key itself as the id with a pattern
dictionary.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.hashing import splitmix64
from ..page import Page, Schema
from ..types import BIGINT, DATE, INTEGER, DecimalType, VarcharType, parse_date_literal

__all__ = ["TpchConnector", "TPCH_SCHEMAS", "Dictionary"]

DEC152 = DecimalType.of(15, 2)
V = VarcharType.of

# -- dictionaries -------------------------------------------------------------------------


@dataclasses.dataclass
class Dictionary:
    """Host-side id->string mapping for a dictionary-encoded varchar column."""

    values: Optional[np.ndarray] = None  # small enum dictionaries
    formatter: Optional[Callable[[np.ndarray], np.ndarray]] = None  # key-derived names
    # printf-style key-derived names ("Customer#%09d"): equivalent to a
    # formatter but PICKLABLE, so fragment outputs can ship dictionaries
    # across worker processes
    pattern: Optional[str] = None

    def decode(self, ids: np.ndarray) -> np.ndarray:
        if self.values is not None:
            return self.values[ids]
        if self.pattern is not None:
            return np.char.mod(self.pattern, ids)
        return self.formatter(ids)

    def lookup(self, s: str) -> int:
        """Literal string -> id (planner-side constant resolution)."""
        if self.values is None:
            raise KeyError(f"cannot look up {s!r} in formatter dictionary")
        hits = np.nonzero(self.values == s)[0]
        if len(hits) == 0:
            return -1  # compares unequal to every id
        return int(hits[0])

    def match(self, pred: Callable[[str], bool]) -> np.ndarray:
        """Boolean lookup table over ids (LIKE / complex string predicates)."""
        if self.values is None:
            raise KeyError("cannot enumerate a formatter dictionary")
        return np.array([bool(pred(str(v))) for v in self.values])

    def map_values(self, fn: Callable[[str], str]):
        """String function over the dictionary: returns (id->new_id lut, new Dictionary)
        — string compute happens once per distinct value at plan time, never on device."""
        if self.values is None:
            raise KeyError("cannot enumerate a formatter dictionary")
        mapped = np.array([fn(str(v)) for v in self.values])
        uniq, inv = np.unique(mapped, return_inverse=True)
        return inv.astype(np.int32), Dictionary(values=uniq)

    def map_values_nullable(self, fn: Callable[[str], Optional[str]]):
        """Like map_values for transforms that can yield SQL NULL: returns
        ((id->new_id lut, id->is_null lut), new Dictionary) — the IR's
        lut_nullable gathers both tables."""
        if self.values is None:
            raise KeyError("cannot enumerate a formatter dictionary")
        mapped = [fn(str(v)) for v in self.values]
        nulls = np.array([m is None for m in mapped])
        filled = np.array(["" if m is None else m for m in mapped])
        uniq, inv = np.unique(filled, return_inverse=True)
        return (inv.astype(np.int32), nulls), Dictionary(values=uniq)


def _enum(*vals):
    return Dictionary(values=np.array(vals))


def _fmt(pattern):
    return Dictionary(pattern=pattern)


SEGMENTS = _enum("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
PRIORITIES = _enum("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
INSTRUCTIONS = _enum("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
MODES = _enum("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
RFLAG = _enum("A", "N", "R")
LSTATUS = _enum("F", "O")
OSTATUS = _enum("F", "O", "P")
NATIONS = [  # (name, regionkey) — TPC-H spec 4.2.3
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATION_DICT = Dictionary(values=np.array([n for n, _ in NATIONS]))
REGION_DICT = Dictionary(values=np.array(REGIONS))
# p_name = color words — spec 4.2.2.13 picks 5 of 92 colors; we pick 2 so the dictionary
# stays enumerable (92^2 values) while LIKE '%green%' / 'forest%' predicates stay selective
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black", "blanched",
    "blue", "blush", "brown", "burlywood", "burnished", "chartreuse", "chiffon",
    "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
    "dim", "dodger", "drab", "firebrick", "floral", "forest", "frosted", "gainsboro",
    "ghost", "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta", "maroon",
    "medium", "metallic", "midnight", "mint", "misty", "moccasin", "navajo", "navy",
    "olive", "orange", "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
    "powder", "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring", "steel",
    "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
PNAMES = _enum(*[f"{a} {b}" for a in COLORS for b in COLORS])
# comments: mostly filler, a deterministic fraction carrying the markers TPC-H predicates
# look for (Q13 '%special%requests%', Q16 '%Customer%Complaints%')
O_COMMENTS = _enum(*[
    f"furiously special packages wake requests {i}" if i % 32 == 0
    else f"quietly final deposits nag {i}"
    for i in range(4096)])
S_COMMENTS = _enum(*[
    f"slyly Customer pending Complaints {i}" if i % 64 == 0
    else f"blithely regular packages boost {i}"
    for i in range(2048)])
# c_phone = "CC-..." with country code 10+nationkey (spec 4.2.2.9); id = nationkey*400+s
PHONE_SUFFIXES = 400
PHONES = _enum(*[f"{10 + nk}-{(s * 7) % 1000:03d}-{(s * 13) % 1000:03d}-{s:04d}"
                 for nk in range(25) for s in range(PHONE_SUFFIXES)])
# p_type = "<syllable1> <syllable2> <syllable3>" — spec 4.2.2.13
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
PTYPES = _enum(*[f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3])
CONTAINERS = _enum(*[f"{a} {b}" for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
                     for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]])
BRANDS = _enum(*[f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)])
MFGRS = _enum(*[f"Manufacturer#{m}" for m in range(1, 6)])

STARTDATE = parse_date_literal("1992-01-01")
CURRENTDATE = parse_date_literal("1995-06-17")
# spec 4.2.3: ENDDATE = 1998-12-31; o_orderdate spans [STARTDATE,
# ENDDATE - 151] (max 1998-08-02).  Round-4 invariants caught ENDDATE set to
# 1998-08-02 directly, which applied the -151 twice and compressed every
# date-window selectivity (Q1's 90-day filter matched 100% of lineitem).
ENDDATE = parse_date_literal("1998-12-31")

# -- RNG ----------------------------------------------------------------------------------


def _rand(stream: int, idx):
    """Counter-based uniform int64 stream: value = mix(stream_salt, index)."""
    salt = int((stream * 0x9E3779B97F4A7C15 + 0x2545F4914F6CDD1D) & 0x7FFFFFFFFFFFFFFF)
    return splitmix64(idx.to(torch.int64) ^ salt)


def _uniform(stream, idx, lo, hi):
    """Uniform integer in [lo, hi] inclusive.  ``abs`` of int64 min stays
    negative and ``%`` is torch.remainder (floor mod), as in the reference."""
    return torch.remainder(torch.abs(_rand(stream, idx)), hi - lo + 1) + lo


# -- schemas ------------------------------------------------------------------------------

TPCH_SCHEMAS: dict[str, Schema] = {
    "lineitem": Schema.of(
        ("l_orderkey", BIGINT), ("l_partkey", BIGINT), ("l_suppkey", BIGINT),
        ("l_linenumber", INTEGER), ("l_quantity", DEC152), ("l_extendedprice", DEC152),
        ("l_discount", DEC152), ("l_tax", DEC152), ("l_returnflag", V(1)),
        ("l_linestatus", V(1)), ("l_shipdate", DATE), ("l_commitdate", DATE),
        ("l_receiptdate", DATE), ("l_shipinstruct", V(25)), ("l_shipmode", V(10)),
        ("l_comment", V(44)),
    ),
    "orders": Schema.of(
        ("o_orderkey", BIGINT), ("o_custkey", BIGINT), ("o_orderstatus", V(1)),
        ("o_totalprice", DEC152), ("o_orderdate", DATE), ("o_orderpriority", V(15)),
        ("o_clerk", V(15)), ("o_shippriority", INTEGER), ("o_comment", V(79)),
    ),
    "customer": Schema.of(
        ("c_custkey", BIGINT), ("c_name", V(25)), ("c_address", V(40)),
        ("c_nationkey", BIGINT), ("c_phone", V(15)), ("c_acctbal", DEC152),
        ("c_mktsegment", V(10)), ("c_comment", V(117)),
    ),
    "part": Schema.of(
        ("p_partkey", BIGINT), ("p_name", V(55)), ("p_mfgr", V(25)), ("p_brand", V(10)),
        ("p_type", V(25)), ("p_size", INTEGER), ("p_container", V(10)),
        ("p_retailprice", DEC152), ("p_comment", V(23)),
    ),
    "supplier": Schema.of(
        ("s_suppkey", BIGINT), ("s_name", V(25)), ("s_address", V(40)),
        ("s_nationkey", BIGINT), ("s_phone", V(15)), ("s_acctbal", DEC152),
        ("s_comment", V(101)),
    ),
    "partsupp": Schema.of(
        ("ps_partkey", BIGINT), ("ps_suppkey", BIGINT), ("ps_availqty", INTEGER),
        ("ps_supplycost", DEC152), ("ps_comment", V(199)),
    ),
    "nation": Schema.of(
        ("n_nationkey", BIGINT), ("n_name", V(25)), ("n_regionkey", BIGINT),
        ("n_comment", V(152)),
    ),
    "region": Schema.of(
        ("r_regionkey", BIGINT), ("r_name", V(25)), ("r_comment", V(152)),
    ),
}

DICTIONARIES: dict[str, dict[str, Dictionary]] = {
    "lineitem": {"l_returnflag": RFLAG, "l_linestatus": LSTATUS, "l_shipinstruct": INSTRUCTIONS,
                 "l_shipmode": MODES, "l_comment": _fmt("line comment %d")},
    "orders": {"o_orderstatus": OSTATUS, "o_orderpriority": PRIORITIES,
               "o_clerk": _fmt("Clerk#%09d"), "o_comment": O_COMMENTS},
    "customer": {"c_name": _fmt("Customer#%09d"), "c_address": _fmt("addr %d"),
                 "c_phone": PHONES, "c_mktsegment": SEGMENTS,
                 "c_comment": _fmt("customer comment %d")},
    "part": {"p_name": PNAMES, "p_mfgr": MFGRS, "p_brand": BRANDS,
             "p_type": PTYPES, "p_container": CONTAINERS, "p_comment": _fmt("part comment %d")},
    "supplier": {"s_name": _fmt("Supplier#%09d"), "s_address": _fmt("saddr %d"),
                 "s_phone": _fmt("sphone-%011d"), "s_comment": S_COMMENTS},
    "partsupp": {"ps_comment": _fmt("partsupp comment %d")},
    "nation": {"n_name": NATION_DICT, "n_comment": _fmt("nation comment %d")},
    "region": {"r_name": REGION_DICT, "r_comment": _fmt("region comment %d")},
}

# table base cardinalities at SF1 (spec 4.2.5); lineitem is derived from orders
BASE_ROWS = {
    "orders": 1_500_000, "customer": 150_000, "part": 200_000, "supplier": 10_000,
    "partsupp": 800_000, "nation": 25, "region": 5,
}
LINES_PER_ORDER_MAX = 7


def _retailprice_raw(partkey):
    """p_retailprice in cents — spec 4.2.3 formula, exact."""
    pk = partkey.to(torch.int64)
    return 90000 + torch.remainder(torch.div(pk, 10, rounding_mode="floor"), 20001) \
        + 100 * torch.remainder(pk, 1000)


def _supplier_for(partkey, supplier_count, i):
    """i-th (0..3) supplier of a part — spec 4.2.3 partsupp formula, exact."""
    pk = partkey.to(torch.int64)
    s = int(supplier_count)
    return torch.remainder(pk + i * (s // 4 + torch.div(pk - 1, s, rounding_mode="floor")),
                           s) + 1


def _i32(x):
    return x.to(torch.int32)


def _lo(lo):
    """A split's first row: a host int, or a 0-d int64 tensor on the device
    (the scan-fused runners read each split's offset from the device, so
    one captured body serves every split)."""
    return lo if isinstance(lo, torch.Tensor) else int(lo)


def _index(lo, length, device):
    return torch.arange(length, dtype=torch.int64, device=device) + _lo(lo)


# -- generators ---------------------------------------------------------------------------


def gen_orders(sf: float, lo, length: int, n: int = 0, device="cpu"):
    """``length`` rows of orders starting at row ``lo``; rows >= n masked out."""
    i = _index(lo, length, device)
    okey = i + 1
    valid = (i < n) if n else None
    ccount = int(BASE_ROWS["customer"] * sf)
    ck = _uniform(11, okey, 1, max(ccount, 1))
    # custkeys divisible by 3 never order (spec 4.2.3)
    ck = torch.clamp(ck - (torch.remainder(ck, 3) == 0).to(torch.int64), min=1)
    od = _uniform(12, okey, STARTDATE, ENDDATE - 151)
    cols = {
        "o_orderkey": okey,
        "o_custkey": ck,
        "o_orderdate": _i32(od),
        "o_orderpriority": _i32(_uniform(13, okey, 0, 4)),
        "o_clerk": _i32(_uniform(14, okey, 1, max(int(1000 * sf), 1))),
        "o_shippriority": torch.zeros_like(okey, dtype=torch.int32),
        "o_comment": _i32(_uniform(16, okey, 0, 4095)),
        "o_totalprice": _uniform(15, okey, 85_000, 55_000_000),  # cents
    }
    # orderstatus: F if all lines shipped, O if all open, else P
    cols["o_orderstatus"] = _i32(torch.where(
        od + 121 < CURRENTDATE, 0, torch.where(od > CURRENTDATE, 1, 2)))
    return cols, valid


def lines_per_order(okey):
    return 1 + torch.remainder(torch.abs(_rand(20, okey)), LINES_PER_ORDER_MAX)


def gen_lineitem(sf: float, order_lo, length: int, n: int = 0, device="cpu"):
    """Line items of ``length`` orders starting at order row ``order_lo``;
    capacity 7/order with a valid mask."""
    r = torch.arange(length * LINES_PER_ORDER_MAX, dtype=torch.int64, device=device)
    okey = torch.div(r, LINES_PER_ORDER_MAX, rounding_mode="floor") + _lo(order_lo) + 1
    lineno = torch.remainder(r, LINES_PER_ORDER_MAX)
    valid = lineno < lines_per_order(okey)
    if n:
        valid = valid & (okey <= n)
    uid = okey * 8 + lineno  # unique per line, stable across splits
    pcount = int(BASE_ROWS["part"] * sf)
    scount = int(BASE_ROWS["supplier"] * sf)
    partkey = _uniform(21, uid, 1, max(pcount, 1))
    qty = _uniform(22, uid, 1, 50)
    odate = _uniform(12, okey, STARTDATE, ENDDATE - 151)  # same stream as orders
    shipdate = odate + _uniform(23, uid, 1, 121)
    commitdate = odate + _uniform(24, uid, 30, 90)
    receiptdate = shipdate + _uniform(25, uid, 1, 30)
    returnable = receiptdate <= CURRENTDATE
    cols = {
        "l_orderkey": okey,
        "l_partkey": partkey,
        "l_suppkey": _supplier_for(partkey, max(scount, 1), _uniform(26, uid, 0, 3)),
        "l_linenumber": _i32(lineno + 1),
        "l_quantity": qty * 100,  # decimal(15,2) raw
        "l_extendedprice": qty * _retailprice_raw(partkey),
        "l_discount": _uniform(27, uid, 0, 10),
        "l_tax": _uniform(28, uid, 0, 8),
        # spec 4.2.3: receipt <= CURRENTDATE -> 'R' or 'A' (50/50), else 'N'
        # (dict ids: A=0, N=1, R=2)
        "l_returnflag": _i32(torch.where(returnable, 2 * _uniform(29, uid, 0, 1), 1)),
        "l_linestatus": _i32((shipdate > CURRENTDATE).to(torch.int64)),
        "l_shipdate": _i32(shipdate),
        "l_commitdate": _i32(commitdate),
        "l_receiptdate": _i32(receiptdate),
        "l_shipinstruct": _i32(_uniform(30, uid, 0, 3)),
        "l_shipmode": _i32(_uniform(31, uid, 0, 6)),
        "l_comment": _i32(torch.remainder(uid, 1 << 31)),
    }
    return cols, valid


def gen_customer(sf, lo, length: int, n: int = 0, device="cpu"):
    i = _index(lo, length, device)
    key = i + 1
    valid = (i < n) if n else None
    nationkey = _uniform(41, key, 0, 24)
    return {
        "c_custkey": key,
        "c_name": _i32(torch.remainder(key, 1 << 31)),
        "c_address": _i32(torch.remainder(key, 1 << 31)),
        "c_nationkey": nationkey,
        "c_phone": _i32(nationkey * PHONE_SUFFIXES
                        + _uniform(44, key, 0, PHONE_SUFFIXES - 1)),
        "c_acctbal": _uniform(42, key, -99_999, 999_999),
        "c_mktsegment": _i32(_uniform(43, key, 0, 4)),
        "c_comment": _i32(torch.remainder(key, 1 << 31)),
    }, valid


def gen_part(sf, lo, length: int, n: int = 0, device="cpu"):
    i = _index(lo, length, device)
    key = i + 1
    valid = (i < n) if n else None
    return {
        "p_partkey": key,
        "p_name": _i32(_uniform(56, key, 0, len(COLORS) ** 2 - 1)),
        "p_mfgr": _i32(_uniform(51, key, 1, 5) - 1),
        "p_brand": _i32(_uniform(51, key, 1, 5) * 5 + _uniform(52, key, 1, 5) - 6),
        "p_type": _i32(_uniform(53, key, 0, 149)),
        "p_size": _i32(_uniform(54, key, 1, 50)),
        "p_container": _i32(_uniform(55, key, 0, 39)),
        "p_retailprice": _retailprice_raw(key),
        "p_comment": _i32(torch.remainder(key, 1 << 31)),
    }, valid


def gen_supplier(sf, lo, length: int, n: int = 0, device="cpu"):
    i = _index(lo, length, device)
    key = i + 1
    valid = (i < n) if n else None
    return {
        "s_suppkey": key,
        "s_name": _i32(torch.remainder(key, 1 << 31)),
        "s_address": _i32(torch.remainder(key, 1 << 31)),
        "s_nationkey": _uniform(61, key, 0, 24),
        "s_phone": _i32(torch.remainder(key, 1 << 31)),
        "s_acctbal": _uniform(62, key, -99_999, 999_999),
        "s_comment": _i32(_uniform(63, key, 0, 2047)),
    }, valid


def gen_partsupp(sf, lo, length: int, n: int = 0, device="cpu"):
    i = _index(lo, length, device)
    valid = (i < n) if n else None
    partkey = torch.div(i, 4, rounding_mode="floor") + 1
    scount = max(int(BASE_ROWS["supplier"] * sf), 1)
    return {
        "ps_partkey": partkey,
        "ps_suppkey": _supplier_for(partkey, scount, torch.remainder(i, 4)),
        "ps_availqty": _i32(_uniform(71, i, 1, 9999)),
        "ps_supplycost": _uniform(72, i, 100, 100_000),
        "ps_comment": _i32(torch.remainder(i, 1 << 31)),
    }, valid


def gen_nation(sf, lo, length: int, n: int = 0, device="cpu"):
    i = _index(lo, length, device)
    valid = i < 25
    # the regions as arithmetic on the index: no host table to copy, so the
    # generator captures into a CUDA graph
    rkeys = _nation_region(torch.clamp(i, 0, 24))
    return {
        "n_nationkey": i,
        "n_name": _i32(i),
        "n_regionkey": rkeys,
        "n_comment": _i32(i),
    }, valid


def gen_region(sf, lo, length: int, n: int = 0, device="cpu"):
    i = _index(lo, length, device)
    return {
        "r_regionkey": i,
        "r_name": _i32(i),
        "r_comment": _i32(i),
    }, i < 5


def _nation_region(i):
    """n_regionkey of nation ``i`` (spec 4.2.3's nation table)."""
    out = torch.zeros_like(i)
    for key, region in enumerate(r for _, r in NATIONS):
        if region:
            out = torch.where(i == key, region, out)
    return out


_GENERATORS = {
    "orders": gen_orders, "lineitem": gen_lineitem, "customer": gen_customer,
    "part": gen_part, "supplier": gen_supplier, "partsupp": gen_partsupp,
    "nation": gen_nation, "region": gen_region,
}


# -- connector SPI ------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpchSplit:
    table: str
    lo: int  # row range (order range for lineitem)
    hi: int


class TpchConnector:
    """Connector over generated TPC-H data."""

    supports_count_pushdown = True  # via exact_row_count below
    CACHEABLE_SCANS = True  # deterministic generator: a (table, split,
    # columns) page is the same for the life of the process, so the buffer
    # pool may serve it across queries

    name = "tpch"

    def __init__(self, sf: float = 1.0, split_rows: int = 1 << 20, device=None):
        self.sf = sf
        self.split_rows = split_rows
        # device the pages are generated on; None = the device of the engine
        # this connector is registered with (Engine.register_catalog binds it)
        self.device = device

    # metadata ---------------------------------------------------------------
    def tables(self):
        return list(TPCH_SCHEMAS)

    def schema(self, table: str) -> Schema:
        return TPCH_SCHEMAS[table]

    _CLUSTERED_BY = {
        # the generators emit each key prefix's rows CONTIGUOUSLY (row index
        # -> key is monotone on the first column; within a part, partsupp's
        # four supplier rows are adjacent but NOT sorted — this is a
        # clustering contract, not a total order); the engine's streaming
        # aggregation needs exactly group contiguity
        "lineitem": ("l_orderkey",),
        "orders": ("o_orderkey",),
        "customer": ("c_custkey",),
        "part": ("p_partkey",),
        "supplier": ("s_suppkey",),
        "partsupp": ("ps_partkey", "ps_suppkey"),
        "nation": ("n_nationkey",),
        "region": ("r_regionkey",),
    }

    def clustered_by(self, table: str) -> tuple:
        """Columns whose equal-value rows are CONTIGUOUS in scan order
        (weaker than sorted: no cross-group ordering promise)."""
        return self._CLUSTERED_BY.get(table, ())

    def dictionaries(self, table: str) -> dict[str, Dictionary]:
        return DICTIONARIES[table]

    def primary_key(self, table: str) -> tuple:
        return {
            "lineitem": ("l_orderkey", "l_linenumber"),
            "orders": ("o_orderkey",),
            "customer": ("c_custkey",),
            "part": ("p_partkey",),
            "supplier": ("s_suppkey",),
            "partsupp": ("ps_partkey", "ps_suppkey"),
            "nation": ("n_nationkey",),
            "region": ("r_regionkey",),
        }[table]

    def column_range(self, table: str, column: str):
        """(min, max) value bounds for stats-aware key packing (reference analog:
        connector stats via spi/statistics; tpch stats in TpchMetadata)."""
        key_max = {
            "l_orderkey": int(BASE_ROWS["orders"] * self.sf),
            "o_orderkey": int(BASE_ROWS["orders"] * self.sf),
            "o_custkey": int(BASE_ROWS["customer"] * self.sf),
            "c_custkey": int(BASE_ROWS["customer"] * self.sf),
            "l_partkey": int(BASE_ROWS["part"] * self.sf),
            "p_partkey": int(BASE_ROWS["part"] * self.sf),
            "ps_partkey": int(BASE_ROWS["part"] * self.sf),
            "l_suppkey": int(BASE_ROWS["supplier"] * self.sf),
            "s_suppkey": int(BASE_ROWS["supplier"] * self.sf),
            "ps_suppkey": int(BASE_ROWS["supplier"] * self.sf),
            "c_nationkey": 24, "s_nationkey": 24, "n_nationkey": 24,
            "n_regionkey": 4, "r_regionkey": 4,
            "l_linenumber": LINES_PER_ORDER_MAX,
        }
        if column in key_max:
            return (0, key_max[column])
        return (None, None)

    def exact_row_count(self, table: str) -> int:
        """EXACT cardinality for count(*) pushdown.  Every table is
        index-derived except lineitem, whose per-order line count is a
        deterministic function of the order key — one tiny device reduction
        computes the exact total without generating any columns."""
        if table != "lineitem":
            return self.row_count(table)
        n_orders = int(BASE_ROWS["orders"] * self.sf)
        keys = torch.arange(1, n_orders + 1, dtype=torch.int64, device=self._device())
        return int(lines_per_order(keys).sum())

    def row_count(self, table: str) -> int:
        if table == "lineitem":  # expected ~4/order; exact count is data-dependent
            return int(BASE_ROWS["orders"] * self.sf) * 4
        if table in ("nation", "region"):
            return BASE_ROWS[table]
        return int(BASE_ROWS[table] * self.sf)

    def table_stats(self, table: str):
        """Analytic TableStats for the CBO (reference: TpchMetadata's statistics
        support feeding spi/statistics/TableStatistics): key ranges/NDVs from
        column_range, dictionary columns exact, plus the generator's known date
        spans and value domains that column_range doesn't carry."""
        from ..spi.statistics import ColumnStats, TableStats

        rows = float(self.row_count(table))
        schema = self.schema(table)
        dicts = self.dictionaries(table)
        extra = {
            # generator domains (see _gen_orders/_gen_lineitem above)
            "o_orderdate": (STARTDATE, ENDDATE - 151),
            "l_shipdate": (STARTDATE + 1, ENDDATE - 151 + 121),
            "l_commitdate": (STARTDATE + 30, ENDDATE - 151 + 90),
            "l_receiptdate": (STARTDATE + 2, ENDDATE - 151 + 151),
            "l_quantity": (100, 5000), "l_discount": (0, 10), "l_tax": (0, 8),
            "c_acctbal": (-99999, 999999), "s_acctbal": (-99999, 999999),
            "ps_supplycost": (100, 100000), "ps_availqty": (1, 9999),
        }
        columns = {}
        for f in schema.fields:
            lo = hi = ndv = None
            r = self.column_range(table, f.name)
            if r and r[0] is not None:
                lo, hi = float(r[0]), float(r[1])
                ndv = hi - lo + 1  # dense integer keys
            elif f.name in extra:
                lo, hi = (float(v) for v in extra[f.name])
                ndv = hi - lo + 1 if not f.type.is_floating else None
            d = dicts.get(f.name)
            if d is not None and getattr(d, "values", None) is not None:
                ndv = float(len(d.values))
            if ndv is not None:
                ndv = min(ndv, rows)
            columns[f.name] = ColumnStats(ndv=ndv, lo=lo, hi=hi)
        return TableStats(rows, columns)

    # splits -----------------------------------------------------------------
    def splits(self, table: str, n_hint: int = 0) -> list[TpchSplit]:
        """Equal-size split ranges (one XLA shape class for the whole scan; trailing rows
        masked via the generator's ``n`` bound)."""
        if table == "lineitem":
            n = int(BASE_ROWS["orders"] * self.sf)
            step = max(self.split_rows // LINES_PER_ORDER_MAX, 1)
        else:
            n = self.row_count(table)
            step = self.split_rows
        step = min(step, n) or 1
        nsplits = -(-n // step)
        if n_hint:
            nsplits = -(-nsplits // n_hint) * n_hint  # round up to a multiple (SPMD batches)
        return [TpchSplit(table, lo, lo + step) for lo in (s * step for s in range(nsplits))]

    def split_range(self, split: TpchSplit, column: str):
        """(min, max) of ``column`` within a split, or None if unknown — row-derived key
        columns are monotone in the row index, so split ranges are exact (the reference
        analog: per-split TupleDomain stats used by dynamic-filter split pruning,
        server/DynamicFilterService.java:101)."""
        if split.table == "lineitem" and column == "l_orderkey":
            return (split.lo + 1, split.hi)
        monotone = {"orders": "o_orderkey", "customer": "c_custkey",
                    "part": "p_partkey", "supplier": "s_suppkey"}
        if monotone.get(split.table) == column:
            return (split.lo + 1, split.hi)  # 1-based keys over the row range
        if split.table in ("nation", "region") and column in ("n_nationkey",
                                                              "r_regionkey"):
            return (split.lo, split.hi - 1)  # 0-based keys
        if split.table == "partsupp" and column == "ps_partkey":
            return (split.lo // 4 + 1, split.hi // 4 + 1)
        return None

    # page source ------------------------------------------------------------
    def table_bound(self, table: str) -> int:
        """Mask bound: orders-count for lineitem, row count otherwise."""
        if table == "lineitem":
            return int(BASE_ROWS["orders"] * self.sf)
        return self.row_count(table)

    def _device(self):
        return torch.device(self.device if self.device is not None else "cpu")

    def generate(self, split: TpchSplit, columns=None) -> Page:
        """One split's page, generated on the connector's device."""
        schema = TPCH_SCHEMAS[split.table]
        names = columns if columns is not None else schema.names
        out_schema = Schema(tuple(schema.field(n) for n in names))
        cols, valid = self.generate_traced(split.table, split.lo, split.hi - split.lo, names)
        return Page(out_schema, cols, tuple(None for _ in cols), valid)

    def generate_traced(self, table: str, lo, length: int, columns):
        """Rows [lo, lo + length) of ``columns`` (an order range for
        lineitem) and their valid mask, on the connector's device: (cols
        tuple, valid).  ``lo`` is a host int or a 0-d int64 tensor on the
        device: nothing on the way reads it on the host, so the scan-fused
        runners capture one body for every split.  The distributed
        executor's scan generates each position's split through it."""
        cols, valid = _GENERATORS[table](self.sf, lo, length, self.table_bound(table),
                                         device=self._device())
        return tuple(cols[c] for c in columns), valid
