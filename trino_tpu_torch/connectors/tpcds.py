"""TPC-DS connector of the PyTorch port (counterpart of
``trino_tpu/connectors/tpcds.py``).

All 24 TPC-DS tables, each column a function of the global row index over
the same counter-based splitmix64 streams as the reference, generated
eagerly on the connector's device one split at a time (the reference jits
one program per split).  Schemas, dictionaries, row counts and every formula
are the reference's, and each column comes out equal to the reference's,
split by split.  Value distributions are the reference's simplified ones
(uniform over spec domains, seasonal sold dates); row counts scale per the
spec's SF table (store_sales ~2.88M rows/SF, catalog_sales ~1.44M,
web_sales ~0.72M, inventory ~11.7M).
"""

from __future__ import annotations

import dataclasses

import torch

from ..page import Field, Page, Schema
from ..sql.ir import _extract_ymd
from ..types import BIGINT, DATE, INTEGER, DecimalType, VarcharType, torch_dtype
from .tpch import _enum, _uniform, parse_date_literal

__all__ = ["TpcdsConnector"]


D72 = DecimalType.of(7, 2)
V = VarcharType.of(None)

# spec row counts at SF1 (scaled tables scale linearly; small dims are fixed)
BASE_ROWS = {
    "store_sales": 2_880_000,
    "customer": 100_000,
    "customer_address": 50_000,
    "item": 18_000,
    "promotion": 300,
    "store": 12,
}
DATE_LO = parse_date_literal("1990-01-01")
DATE_HI = parse_date_literal("2002-12-31")
N_DATES = DATE_HI - DATE_LO + 1  # date_dim rows (sk = julian-style day index)
JULIAN_BASE = 2450000  # d_date_sk offset so sks look spec-like

GENDERS = _enum("M", "F")
MARITAL = _enum("M", "S", "D", "W", "U")
EDUCATION = _enum("Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
                  "Advanced Degree", "Unknown")
CREDIT = _enum("Low Risk", "High Risk", "Unknown", "Good")
CATEGORIES = _enum("Home", "Books", "Electronics", "Jewelry", "Music", "Shoes",
                   "Sports", "Women", "Men", "Children")
N_CAT = 10
BRAND_DICT = _enum(*[f"corpbrand #{i}" for i in range(1, 101)])
CLASSES = _enum(*[f"class{i:02d}" for i in range(50)])
MANAGERS = _enum(*[f"Manager {i}" for i in range(1, 101)])
STATES = _enum("TN", "CA", "TX", "NY", "OH", "GA", "IL", "WA", "NC", "VA")
COUNTIES = _enum(*[f"{w} County" for w in
                   ("Williamson", "Ziebach", "Walker", "Daviess", "Barrow",
                    "Franklin", "Luce", "Richland", "Oglethorpe", "Mobile")])
CITIES = _enum(*[f"City{i:03d}" for i in range(200)])
FIRST_NAMES = _enum(*[f"First{i:03d}" for i in range(512)])
LAST_NAMES = _enum(*[f"Last{i:03d}" for i in range(512)])
STORE_NAMES = _enum("ese", "anti", "ought", "able", "pri", "cally", "ation", "eing",
                    "n st", "bar", "cal", "ought2")
PROMO_NAMES = _enum(*[f"promo{i:03d}" for i in range(300)])
ITEM_IDS = _enum(*[f"AAAAAAAA{i:08d}" for i in range(BASE_ROWS["item"])])
CHANNELS = _enum("N", "Y")

# customer_demographics: the spec's full cross product of attribute domains
CD_GENDER, CD_MARITAL, CD_EDU = 2, 5, 7
CD_PURCHASE = 20  # purchase estimate buckets (500..10000 step 500)
CD_CREDIT = 4
CD_DEP, CD_EMP, CD_COLL = 7, 7, 7
CD_ROWS = CD_GENDER * CD_MARITAL * CD_EDU * CD_PURCHASE * CD_CREDIT \
    * CD_DEP * CD_EMP * CD_COLL  # 1,920,800 (spec row count)


def _schema(*fields):
    return Schema(tuple(Field(n, t) for n, t in fields))


SCHEMAS = {
    "date_dim": _schema(
        ("d_date_sk", BIGINT), ("d_date_id", BIGINT), ("d_date", DATE),
        ("d_month_seq", INTEGER), ("d_week_seq", INTEGER), ("d_quarter_seq", INTEGER),
        ("d_year", INTEGER), ("d_dow", INTEGER), ("d_moy", INTEGER),
        ("d_dom", INTEGER), ("d_qoy", INTEGER), ("d_fy_year", INTEGER),
        ("d_day_name", V), ("d_holiday", V), ("d_weekend", V),
        ("d_following_holiday", V), ("d_first_dom", INTEGER),
        ("d_last_dom", INTEGER), ("d_same_day_ly", INTEGER),
        ("d_same_day_lq", INTEGER), ("d_current_day", V), ("d_current_week", V),
        ("d_current_month", V), ("d_current_quarter", V), ("d_current_year", V),
    ),
    "item": _schema(
        ("i_item_sk", BIGINT), ("i_item_id", V), ("i_rec_start_date", DATE),
        ("i_rec_end_date", DATE), ("i_item_desc", V), ("i_current_price", D72),
        ("i_wholesale_cost", D72), ("i_brand_id", INTEGER), ("i_brand", V),
        ("i_class_id", INTEGER), ("i_class", V), ("i_category_id", INTEGER),
        ("i_category", V), ("i_manufact_id", INTEGER), ("i_manufact", V),
        ("i_size", V), ("i_formulation", V), ("i_color", V), ("i_units", V),
        ("i_container", V), ("i_manager_id", INTEGER), ("i_product_name", V),
    ),
    "customer": _schema(
        ("c_customer_sk", BIGINT), ("c_customer_id", BIGINT),
        ("c_current_cdemo_sk", BIGINT), ("c_current_hdemo_sk", BIGINT),
        ("c_current_addr_sk", BIGINT), ("c_first_shipto_date_sk", BIGINT),
        ("c_first_sales_date_sk", BIGINT), ("c_salutation", V),
        ("c_first_name", V), ("c_last_name", V), ("c_preferred_cust_flag", V),
        ("c_birth_day", INTEGER), ("c_birth_month", INTEGER),
        ("c_birth_year", INTEGER), ("c_birth_country", V), ("c_login", V),
        ("c_email_address", V), ("c_last_review_date_sk", BIGINT),
    ),
    "customer_address": _schema(
        ("ca_address_sk", BIGINT), ("ca_address_id", BIGINT),
        ("ca_street_number", INTEGER), ("ca_street_name", V),
        ("ca_street_type", V), ("ca_suite_number", V), ("ca_city", V),
        ("ca_county", V), ("ca_state", V), ("ca_zip", INTEGER), ("ca_country", V),
        ("ca_gmt_offset", DecimalType.of(5, 2)), ("ca_location_type", V),
    ),
    "customer_demographics": _schema(
        ("cd_demo_sk", BIGINT), ("cd_gender", V), ("cd_marital_status", V),
        ("cd_education_status", V), ("cd_purchase_estimate", INTEGER),
        ("cd_credit_rating", V), ("cd_dep_count", INTEGER),
        ("cd_dep_employed_count", INTEGER), ("cd_dep_college_count", INTEGER),
    ),
    "store": _schema(
        ("s_store_sk", BIGINT), ("s_store_id", BIGINT), ("s_rec_start_date", DATE),
        ("s_rec_end_date", DATE), ("s_closed_date_sk", BIGINT), ("s_store_name", V),
        ("s_number_employees", INTEGER), ("s_floor_space", INTEGER),
        ("s_hours", V), ("s_manager", V), ("s_market_id", INTEGER),
        ("s_geography_class", V), ("s_market_desc", V), ("s_market_manager", V),
        ("s_division_id", INTEGER), ("s_division_name", V), ("s_company_id", INTEGER),
        ("s_company_name", V), ("s_street_number", INTEGER), ("s_street_name", V),
        ("s_street_type", V), ("s_suite_number", V), ("s_city", V), ("s_county", V),
        ("s_state", V), ("s_zip", INTEGER), ("s_country", V),
        ("s_gmt_offset", DecimalType.of(5, 2)), ("s_tax_precentage", D72),
    ),
    "promotion": _schema(
        ("p_promo_sk", BIGINT), ("p_promo_id", BIGINT), ("p_start_date_sk", BIGINT),
        ("p_end_date_sk", BIGINT), ("p_item_sk", BIGINT), ("p_cost", D72),
        ("p_response_target", INTEGER), ("p_promo_name", V), ("p_channel_dmail", V),
        ("p_channel_email", V), ("p_channel_catalog", V), ("p_channel_tv", V),
        ("p_channel_radio", V), ("p_channel_press", V), ("p_channel_event", V),
        ("p_channel_demo", V), ("p_channel_details", V), ("p_purpose", V),
        ("p_discount_active", V),
    ),
    "store_sales": _schema(
        ("ss_sold_date_sk", BIGINT), ("ss_sold_time_sk", BIGINT),
        ("ss_item_sk", BIGINT), ("ss_customer_sk", BIGINT), ("ss_cdemo_sk", BIGINT),
        ("ss_hdemo_sk", BIGINT), ("ss_addr_sk", BIGINT), ("ss_store_sk", BIGINT),
        ("ss_promo_sk", BIGINT), ("ss_ticket_number", BIGINT),
        ("ss_quantity", INTEGER), ("ss_wholesale_cost", D72), ("ss_list_price", D72),
        ("ss_sales_price", D72), ("ss_ext_discount_amt", D72),
        ("ss_ext_sales_price", D72), ("ss_ext_wholesale_cost", D72),
        ("ss_ext_list_price", D72), ("ss_ext_tax", D72), ("ss_coupon_amt", D72),
        ("ss_net_paid", D72), ("ss_net_paid_inc_tax", D72), ("ss_net_profit", D72),
    ),
}

DAY_NAMES = _enum("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                  "Saturday")
YN = _enum("N", "Y")

DICTS = {
    "date_dim": {"d_day_name": DAY_NAMES, "d_holiday": YN, "d_weekend": YN,
                 "d_following_holiday": YN, "d_current_day": YN,
                 "d_current_week": YN, "d_current_month": YN,
                 "d_current_quarter": YN, "d_current_year": YN},
    "item": {"i_item_id": ITEM_IDS, "i_item_desc": ITEM_IDS, "i_brand": BRAND_DICT,
             "i_class": CLASSES, "i_category": CATEGORIES, "i_manufact": BRAND_DICT,
             "i_size": _enum("small", "medium", "large", "extra large", "petite",
                             "economy", "N/A"),
             "i_formulation": ITEM_IDS, "i_color": _enum(
                 "red", "green", "blue", "yellow", "purple", "white", "black",
                 "orange", "pink", "brown"),
             "i_units": _enum("Each", "Dozen", "Case", "Pallet", "Gross", "Box"),
             "i_container": _enum("Unknown"), "i_product_name": ITEM_IDS},
    "customer": {"c_salutation": _enum("Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"),
                 "c_first_name": FIRST_NAMES, "c_last_name": LAST_NAMES,
                 "c_preferred_cust_flag": YN,
                 "c_birth_country": _enum("UNITED STATES", "CANADA", "MEXICO",
                                          "GERMANY", "JAPAN", "BRAZIL", "INDIA"),
                 "c_login": FIRST_NAMES, "c_email_address": FIRST_NAMES},
    "customer_address": {"ca_street_name": CITIES,
                         "ca_street_type": _enum("Street", "Ave", "Blvd", "Way",
                                                 "Court", "Lane"),
                         "ca_suite_number": _enum(*[f"Suite {i}" for i in range(50)]),
                         "ca_city": CITIES, "ca_county": COUNTIES,
                         "ca_state": STATES,
                         "ca_country": _enum("United States"),
                         "ca_location_type": _enum("apartment", "condo",
                                                   "single family")},
    "customer_demographics": {"cd_gender": GENDERS, "cd_marital_status": MARITAL,
                              "cd_education_status": EDUCATION,
                              "cd_credit_rating": CREDIT},
    "store": {"s_store_name": STORE_NAMES, "s_hours": _enum("8AM-8PM", "8AM-4PM",
                                                            "8AM-12AM"),
              "s_manager": MANAGERS, "s_geography_class": _enum("Unknown"),
              "s_market_desc": COUNTIES, "s_market_manager": MANAGERS,
              "s_division_name": _enum("Unknown"), "s_company_name": _enum("Unknown"),
              "s_street_name": CITIES, "s_street_type": _enum("Street", "Ave"),
              "s_suite_number": _enum(*[f"Suite {i}" for i in range(50)]),
              "s_city": CITIES, "s_county": COUNTIES, "s_state": STATES,
              "s_country": _enum("United States")},
    "promotion": {"p_promo_name": PROMO_NAMES, "p_channel_dmail": CHANNELS,
                  "p_channel_email": CHANNELS, "p_channel_catalog": CHANNELS,
                  "p_channel_tv": CHANNELS, "p_channel_radio": CHANNELS,
                  "p_channel_press": CHANNELS, "p_channel_event": CHANNELS,
                  "p_channel_demo": CHANNELS, "p_channel_details": PROMO_NAMES,
                  "p_purpose": _enum("Unknown"), "p_discount_active": CHANNELS},
    "store_sales": {},
}


class _Columns(dict):
    """A generator's columns, each computed from its thunk when first read:
    a scan generates only the columns it asks for."""

    def __getitem__(self, name):
        v = super().__getitem__(name)
        if not isinstance(v, torch.Tensor):
            v = v()
            super().__setitem__(name, v)
        return v


def _once(fn):
    """``fn()`` computed at the first call only (an intermediate that several
    columns share)."""
    cell = []

    def get():
        if not cell:
            cell.append(fn())
        return cell[0]

    return get


def _index(lo, length, device):
    """Row indices [lo, lo + length): ``lo`` a host int or a 0-d int64
    tensor on the device (the scan-fused runners' split offset)."""
    return torch.arange(length, dtype=torch.int64, device=device) \
        + (lo if isinstance(lo, torch.Tensor) else int(lo))


def _full(length, value, device):
    return torch.full((length,), int(value), dtype=torch.int64, device=device)


def _seasonal_date(seed: int, i):
    """Sold-date day index with retail seasonality (dsdgen skews sales toward
    the year-end holiday season): a uniform base candidate is replaced by a
    second candidate whenever that one lands in October-December, putting
    ~2.3x per-day weight on Q4 days while every calendar day keeps nonzero
    mass."""
    d1 = _uniform(seed, i, 0, N_DATES - 1)
    d2 = _uniform(seed * 7919 + 13, i, 0, N_DATES - 1)
    _, m2, _ = _extract_ymd((DATE_LO + d2).to(torch.int32))
    return torch.where(m2 >= 10, d2, d1)


# -- per-table generators (row index -> columns) ------------------------------------------
def gen_date_dim(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    days = (DATE_LO + i).to(torch.int32)
    y, m, d = _extract_ymd(days)
    dow = ((days.to(torch.int64) + 4) % 7).to(torch.int32)  # 1970-01-01 = Thursday
    qoy = ((m - 1) // 3 + 1).to(torch.int32)
    month_seq = ((y - 1900) * 12 + (m - 1)).to(torch.int32)
    week_seq = ((DATE_LO + i) // 7).to(torch.int32)
    return _Columns({
        "d_date_sk": lambda: JULIAN_BASE + i,
        "d_date_id": lambda: i,
        "d_date": lambda: days,
        "d_month_seq": lambda: month_seq,
        "d_week_seq": lambda: week_seq,
        "d_quarter_seq": lambda: ((y - 1900) * 4 + qoy - 1).to(torch.int32),
        "d_year": lambda: y.to(torch.int32),
        "d_dow": lambda: dow,
        "d_moy": lambda: m.to(torch.int32),
        "d_dom": lambda: d.to(torch.int32),
        "d_qoy": lambda: qoy,
        "d_fy_year": lambda: y.to(torch.int32),
        "d_day_name": lambda: dow.to(torch.int32),
        "d_holiday": lambda: ((m == 12) & (d == 25)).to(torch.int32),
        "d_weekend": lambda: ((dow == 0) | (dow == 6)).to(torch.int32),
        "d_following_holiday": lambda: ((m == 12) & (d == 26)).to(torch.int32),
        "d_first_dom": lambda: (days - d + 1).to(torch.int32),
        "d_last_dom": lambda: (days + 27).to(torch.int32),
        "d_same_day_ly": lambda: (days - 365).to(torch.int32),
        "d_same_day_lq": lambda: (days - 91).to(torch.int32),
        "d_current_day": lambda: _full(length, 0, device),
        "d_current_week": lambda: _full(length, 0, device),
        "d_current_month": lambda: _full(length, 0, device),
        "d_current_quarter": lambda: _full(length, 0, device),
        "d_current_year": lambda: _full(length, 0, device),
    })


def gen_item(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    brand_id = _uniform(101, sk, 1, 100).to(torch.int32)
    class_id = _uniform(102, sk, 1, 50).to(torch.int32)
    cat_id = (sk % N_CAT).to(torch.int32) + 1
    manu_id = _uniform(104, sk, 1, 100).to(torch.int32)
    price = _uniform(105, sk, 99, 9999)
    return _Columns({
        "i_item_sk": lambda: sk,
        "i_item_id": lambda: (i % BASE_ROWS["item"]).to(torch.int32),
        "i_rec_start_date": lambda: _full(length, DATE_LO, device),
        "i_rec_end_date": lambda: _full(length, DATE_HI, device),
        "i_item_desc": lambda: (i % BASE_ROWS["item"]).to(torch.int32),
        "i_current_price": lambda: price,
        "i_wholesale_cost": lambda: (price * 6) // 10,
        "i_brand_id": lambda: brand_id,
        "i_brand": lambda: brand_id - 1,
        "i_class_id": lambda: class_id,
        "i_class": lambda: class_id - 1,
        "i_category_id": lambda: cat_id,
        "i_category": lambda: cat_id - 1,
        "i_manufact_id": lambda: manu_id,
        "i_manufact": lambda: manu_id - 1,
        "i_size": lambda: (sk % 7).to(torch.int32),
        "i_formulation": lambda: (i % BASE_ROWS["item"]).to(torch.int32),
        "i_color": lambda: (sk % 10).to(torch.int32),
        "i_units": lambda: (sk % 6).to(torch.int32),
        "i_container": lambda: _full(length, 0, device),
        "i_manager_id": lambda: _uniform(106, sk, 1, 100).to(torch.int32),
        "i_product_name": lambda: (i % BASE_ROWS["item"]).to(torch.int32),
    })


def gen_customer(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    n_addr = max(int(BASE_ROWS["customer_address"] * sf), 1)
    return _Columns({
        "c_customer_sk": lambda: sk,
        "c_customer_id": lambda: sk,
        "c_current_cdemo_sk": lambda: _uniform(201, sk, 1, CD_ROWS),
        "c_current_hdemo_sk": lambda: _uniform(202, sk, 1, 7200),
        "c_current_addr_sk": lambda: _uniform(203, sk, 1, n_addr),
        "c_first_shipto_date_sk": lambda: JULIAN_BASE + _uniform(204, sk, 0, N_DATES - 1),
        "c_first_sales_date_sk": lambda: JULIAN_BASE + _uniform(205, sk, 0, N_DATES - 1),
        "c_salutation": lambda: (sk % 6).to(torch.int32),
        "c_first_name": lambda: (_uniform(206, sk, 0, 511)).to(torch.int32),
        "c_last_name": lambda: (_uniform(207, sk, 0, 511)).to(torch.int32),
        "c_preferred_cust_flag": lambda: (sk % 2).to(torch.int32),
        "c_birth_day": lambda: _uniform(208, sk, 1, 28).to(torch.int32),
        "c_birth_month": lambda: _uniform(209, sk, 1, 12).to(torch.int32),
        "c_birth_year": lambda: _uniform(210, sk, 1930, 1990).to(torch.int32),
        "c_birth_country": lambda: (sk % 7).to(torch.int32),
        "c_login": lambda: (_uniform(206, sk, 0, 511)).to(torch.int32),
        "c_email_address": lambda: (_uniform(206, sk, 0, 511)).to(torch.int32),
        "c_last_review_date_sk": lambda: JULIAN_BASE + _uniform(211, sk, 0, N_DATES - 1),
    })


def gen_customer_address(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "ca_address_sk": lambda: sk,
        "ca_address_id": lambda: sk,
        "ca_street_number": lambda: _uniform(301, sk, 1, 999).to(torch.int32),
        "ca_street_name": lambda: (_uniform(302, sk, 0, 199)).to(torch.int32),
        "ca_street_type": lambda: (sk % 6).to(torch.int32),
        "ca_suite_number": lambda: (sk % 50).to(torch.int32),
        "ca_city": lambda: (_uniform(303, sk, 0, 199)).to(torch.int32),
        "ca_county": lambda: (sk % 10).to(torch.int32),
        "ca_state": lambda: (_uniform(304, sk, 0, 9)).to(torch.int32),
        "ca_zip": lambda: _uniform(305, sk, 10000, 99999).to(torch.int32),
        "ca_country": lambda: _full(length, 0, device),
        "ca_gmt_offset": lambda: _full(length, -500, device),
        "ca_location_type": lambda: (sk % 3).to(torch.int32),
    })


def gen_customer_demographics(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    # cross-product decomposition of the demo key (spec: cd is the full cross join)
    r = i
    gender = (r % CD_GENDER).to(torch.int32); r = r // CD_GENDER
    marital = (r % CD_MARITAL).to(torch.int32); r = r // CD_MARITAL
    edu = (r % CD_EDU).to(torch.int32); r = r // CD_EDU
    purchase = (r % CD_PURCHASE).to(torch.int32); r = r // CD_PURCHASE
    credit = (r % CD_CREDIT).to(torch.int32); r = r // CD_CREDIT
    dep = (r % CD_DEP).to(torch.int32); r = r // CD_DEP
    emp = (r % CD_EMP).to(torch.int32); r = r // CD_EMP
    coll = (r % CD_COLL).to(torch.int32)
    return _Columns({
        "cd_demo_sk": lambda: sk,
        "cd_gender": lambda: gender,
        "cd_marital_status": lambda: marital,
        "cd_education_status": lambda: edu,
        "cd_purchase_estimate": lambda: (purchase + 1) * 500,
        "cd_credit_rating": lambda: credit,
        "cd_dep_count": lambda: dep,
        "cd_dep_employed_count": lambda: emp,
        "cd_dep_college_count": lambda: coll,
    })


def gen_store(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "s_store_sk": lambda: sk,
        "s_store_id": lambda: sk,
        "s_rec_start_date": lambda: _full(length, DATE_LO, device),
        "s_rec_end_date": lambda: _full(length, DATE_HI, device),
        "s_closed_date_sk": lambda: _full(length, 0, device),
        "s_store_name": lambda: (i % 12).to(torch.int32),
        "s_number_employees": lambda: _uniform(401, sk, 200, 300).to(torch.int32),
        "s_floor_space": lambda: _uniform(402, sk, 5_000_000, 9_999_999).to(torch.int32),
        "s_hours": lambda: (sk % 3).to(torch.int32),
        "s_manager": lambda: (_uniform(403, sk, 0, 99)).to(torch.int32),
        "s_market_id": lambda: _uniform(404, sk, 1, 10).to(torch.int32),
        "s_geography_class": lambda: _full(length, 0, device),
        "s_market_desc": lambda: (sk % 10).to(torch.int32),
        "s_market_manager": lambda: (_uniform(405, sk, 0, 99)).to(torch.int32),
        "s_division_id": lambda: _full(length, 1, device),
        "s_division_name": lambda: _full(length, 0, device),
        "s_company_id": lambda: _full(length, 1, device),
        "s_company_name": lambda: _full(length, 0, device),
        "s_street_number": lambda: _uniform(406, sk, 1, 999).to(torch.int32),
        "s_street_name": lambda: (_uniform(407, sk, 0, 199)).to(torch.int32),
        "s_street_type": lambda: (sk % 2).to(torch.int32),
        "s_suite_number": lambda: (sk % 50).to(torch.int32),
        "s_city": lambda: (_uniform(408, sk, 0, 199)).to(torch.int32),
        "s_county": lambda: (sk % 10).to(torch.int32),
        "s_state": lambda: (sk % 10).to(torch.int32),
        "s_zip": lambda: _uniform(409, sk, 10000, 99999).to(torch.int32),
        "s_country": lambda: _full(length, 0, device),
        "s_gmt_offset": lambda: _full(length, -500, device),
        "s_tax_precentage": lambda: _uniform(410, sk, 0, 11),
    })


def gen_promotion(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    n_item = max(int(BASE_ROWS["item"] * sf), 1)
    start = JULIAN_BASE + _uniform(501, sk, 0, N_DATES - 60)
    return _Columns({
        "p_promo_sk": lambda: sk,
        "p_promo_id": lambda: sk,
        "p_start_date_sk": lambda: start,
        "p_end_date_sk": lambda: start + _uniform(502, sk, 10, 60),
        "p_item_sk": lambda: _uniform(503, sk, 1, n_item),
        "p_cost": lambda: _full(length, 100000, device),
        "p_response_target": lambda: _full(length, 1, device),
        "p_promo_name": lambda: (i % 300).to(torch.int32),
        "p_channel_dmail": lambda: (sk % 2).to(torch.int32),
        "p_channel_email": lambda: ((sk // 2) % 2).to(torch.int32),
        "p_channel_catalog": lambda: ((sk // 4) % 2).to(torch.int32),
        "p_channel_tv": lambda: ((sk // 8) % 2).to(torch.int32),
        "p_channel_radio": lambda: ((sk // 16) % 2).to(torch.int32),
        "p_channel_press": lambda: ((sk // 32) % 2).to(torch.int32),
        "p_channel_event": lambda: ((sk // 64) % 2).to(torch.int32),
        "p_channel_demo": lambda: ((sk // 128) % 2).to(torch.int32),
        "p_channel_details": lambda: (i % 300).to(torch.int32),
        "p_purpose": lambda: _full(length, 0, device),
        "p_discount_active": lambda: (sk % 2).to(torch.int32),
    })


def gen_store_sales(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    fk = _fk_counts(sf)
    # _sale_measures(601) keeps the seed layout (601 qty .. 605 coupon); its
    # ship measure (seed 606) is unused here, so the seed overlap with
    # ss_sold_date_sk is harmless
    m = _once(lambda: _sale_measures(601, i))
    return _Columns({
        "ss_sold_date_sk": lambda: JULIAN_BASE + _seasonal_date(606, i),
        "ss_sold_time_sk": lambda: _uniform(607, i, 28800, 75600),
        "ss_item_sk": lambda: _uniform(608, i, 1, fk["item"]),
        "ss_customer_sk": lambda: _uniform(609, i, 1, fk["customer"]),
        "ss_cdemo_sk": lambda: _uniform(610, i, 1, CD_ROWS),
        "ss_hdemo_sk": lambda: _uniform(611, i, 1, fk["hd"]),
        "ss_addr_sk": lambda: _uniform(612, i, 1, fk["addr"]),
        "ss_store_sk": lambda: _uniform(613, i, 1, fk["store"]),
        "ss_promo_sk": lambda: _uniform(614, i, 1, fk["promo"]),
        "ss_ticket_number": lambda: i // 12 + 1,
        "ss_quantity": lambda: m()["quantity"],
        "ss_wholesale_cost": lambda: m()["wholesale_cost"],
        "ss_list_price": lambda: m()["list_price"],
        "ss_sales_price": lambda: m()["sales_price"],
        "ss_ext_discount_amt": lambda: m()["ext_discount_amt"],
        "ss_ext_sales_price": lambda: m()["ext_sales_price"],
        "ss_ext_wholesale_cost": lambda: m()["ext_wholesale_cost"],
        "ss_ext_list_price": lambda: m()["ext_list_price"],
        "ss_ext_tax": lambda: m()["ext_tax"],
        "ss_coupon_amt": lambda: m()["coupon_amt"],
        "ss_net_paid": lambda: m()["net_paid"],
        "ss_net_paid_inc_tax": lambda: m()["net_paid_inc_tax"],
        "ss_net_profit": lambda: m()["net_profit"],
    })


# -- the catalog and web channels, returns, inventory, and the remaining
# dimensions (24 tables in all: the TPC-DS vocabulary minus dbgen's text
# corpora; distributions stay simplified-uniform as documented)

BASE_ROWS.update({
    "catalog_sales": 1_441_548, "catalog_returns": 144_067,
    "web_sales": 719_384, "web_returns": 71_763,
    "store_returns": 287_514, "inventory": 11_745_000,
    "catalog_page": 11_718, "warehouse": 5, "web_site": 30, "web_page": 60,
    "call_center": 6,
})
FIXED_ROWS = {"time_dim": 86_400, "household_demographics": 7_200,
              "income_band": 20, "ship_mode": 20, "reason": 35}
MIN_SCALED = {"store": 1 / 12, "promotion": 1 / 300, "warehouse": 1 / 5,
              "web_site": 1 / 30, "web_page": 1 / 60, "call_center": 1 / 6,
              "catalog_page": 1 / 11_718}

D52 = DecimalType.of(5, 2)
SHIP_TYPES = _enum("EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY")
CARRIERS = _enum("UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
                 "LATVIAN", "DIAMOND", "ALLIANCE")
REASONS = _enum(*[f"reason {i}" for i in range(1, 36)])
BUY_POTENTIAL = _enum(">10000", "5001-10000", "1001-5000", "501-1000",
                      "0-500", "Unknown")
SHIFTS = _enum("first", "second", "third")
MEALS = _enum("breakfast", "lunch", "dinner", "")
AMPM = _enum("AM", "PM")
WAREHOUSE_NAMES = _enum("Conventional childr", "Important issues liv",
                        "Doors canno", "Bad cards must make.", "eing")
URLS = _enum("http://www.foo.com", "http://www.bar.com")
PAGE_TYPES = _enum("ad", "bio", "feedback", "general", "order", "protected",
                   "welcome")
DEPARTMENTS = _enum("DEPARTMENT")
CC_NAMES = _enum("NY Metro", "Mid Atlantic", "Pacific Northwest",
                 "North Midwest", "California", "Hawaii/Alaska")
CC_CLASSES = _enum("small", "medium", "large")
CATALOG_TYPES = _enum("bi-annual", "quarterly", "monthly")

SCHEMAS.update({
    "warehouse": _schema(
        ("w_warehouse_sk", BIGINT), ("w_warehouse_id", BIGINT),
        ("w_warehouse_name", V), ("w_warehouse_sq_ft", INTEGER),
        ("w_street_number", INTEGER), ("w_street_name", V),
        ("w_street_type", V), ("w_suite_number", V), ("w_city", V),
        ("w_county", V), ("w_state", V), ("w_zip", INTEGER), ("w_country", V),
        ("w_gmt_offset", D52),
    ),
    "ship_mode": _schema(
        ("sm_ship_mode_sk", BIGINT), ("sm_ship_mode_id", BIGINT),
        ("sm_type", V), ("sm_code", V), ("sm_carrier", V), ("sm_contract", V),
    ),
    "reason": _schema(
        ("r_reason_sk", BIGINT), ("r_reason_id", BIGINT),
        ("r_reason_desc", V),
    ),
    "income_band": _schema(
        ("ib_income_band_sk", BIGINT), ("ib_lower_bound", INTEGER),
        ("ib_upper_bound", INTEGER),
    ),
    "household_demographics": _schema(
        ("hd_demo_sk", BIGINT), ("hd_income_band_sk", BIGINT),
        ("hd_buy_potential", V), ("hd_dep_count", INTEGER),
        ("hd_vehicle_count", INTEGER),
    ),
    "time_dim": _schema(
        ("t_time_sk", BIGINT), ("t_time_id", BIGINT), ("t_time", INTEGER),
        ("t_hour", INTEGER), ("t_minute", INTEGER), ("t_second", INTEGER),
        ("t_am_pm", V), ("t_shift", V), ("t_sub_shift", V), ("t_meal_time", V),
    ),
    "web_site": _schema(
        ("web_site_sk", BIGINT), ("web_site_id", BIGINT),
        ("web_rec_start_date", DATE), ("web_rec_end_date", DATE),
        ("web_name", V), ("web_open_date_sk", BIGINT),
        ("web_close_date_sk", BIGINT), ("web_class", V), ("web_manager", V),
        ("web_mkt_id", INTEGER), ("web_mkt_class", V), ("web_mkt_desc", V),
        ("web_market_manager", V), ("web_company_id", INTEGER),
        ("web_company_name", V), ("web_street_number", INTEGER),
        ("web_street_name", V), ("web_street_type", V),
        ("web_suite_number", V), ("web_city", V), ("web_county", V),
        ("web_state", V), ("web_zip", INTEGER), ("web_country", V),
        ("web_gmt_offset", D52), ("web_tax_percentage", D72),
    ),
    "web_page": _schema(
        ("wp_web_page_sk", BIGINT), ("wp_web_page_id", BIGINT),
        ("wp_rec_start_date", DATE), ("wp_rec_end_date", DATE),
        ("wp_creation_date_sk", BIGINT), ("wp_access_date_sk", BIGINT),
        ("wp_autogen_flag", V), ("wp_customer_sk", BIGINT), ("wp_url", V),
        ("wp_type", V), ("wp_char_count", INTEGER), ("wp_link_count", INTEGER),
        ("wp_image_count", INTEGER), ("wp_max_ad_count", INTEGER),
    ),
    "call_center": _schema(
        ("cc_call_center_sk", BIGINT), ("cc_call_center_id", BIGINT),
        ("cc_rec_start_date", DATE), ("cc_rec_end_date", DATE),
        ("cc_closed_date_sk", BIGINT), ("cc_open_date_sk", BIGINT),
        ("cc_name", V), ("cc_class", V), ("cc_employees", INTEGER),
        ("cc_sq_ft", INTEGER), ("cc_hours", V), ("cc_manager", V),
        ("cc_mkt_id", INTEGER), ("cc_mkt_class", V), ("cc_mkt_desc", V),
        ("cc_market_manager", V), ("cc_division", INTEGER),
        ("cc_division_name", V), ("cc_company", INTEGER),
        ("cc_company_name", V), ("cc_street_number", INTEGER),
        ("cc_street_name", V), ("cc_street_type", V), ("cc_suite_number", V),
        ("cc_city", V), ("cc_county", V), ("cc_state", V), ("cc_zip", INTEGER),
        ("cc_country", V), ("cc_gmt_offset", D52), ("cc_tax_percentage", D72),
    ),
    "catalog_page": _schema(
        ("cp_catalog_page_sk", BIGINT), ("cp_catalog_page_id", BIGINT),
        ("cp_start_date_sk", BIGINT), ("cp_end_date_sk", BIGINT),
        ("cp_department", V), ("cp_catalog_number", INTEGER),
        ("cp_catalog_page_number", INTEGER), ("cp_description", V),
        ("cp_type", V),
    ),
    "inventory": _schema(
        ("inv_date_sk", BIGINT), ("inv_item_sk", BIGINT),
        ("inv_warehouse_sk", BIGINT), ("inv_quantity_on_hand", INTEGER),
    ),
    "catalog_sales": _schema(
        ("cs_sold_date_sk", BIGINT), ("cs_sold_time_sk", BIGINT),
        ("cs_ship_date_sk", BIGINT), ("cs_bill_customer_sk", BIGINT),
        ("cs_bill_cdemo_sk", BIGINT), ("cs_bill_hdemo_sk", BIGINT),
        ("cs_bill_addr_sk", BIGINT), ("cs_ship_customer_sk", BIGINT),
        ("cs_ship_cdemo_sk", BIGINT), ("cs_ship_hdemo_sk", BIGINT),
        ("cs_ship_addr_sk", BIGINT), ("cs_call_center_sk", BIGINT),
        ("cs_catalog_page_sk", BIGINT), ("cs_ship_mode_sk", BIGINT),
        ("cs_warehouse_sk", BIGINT), ("cs_item_sk", BIGINT),
        ("cs_promo_sk", BIGINT), ("cs_order_number", BIGINT),
        ("cs_quantity", INTEGER), ("cs_wholesale_cost", D72),
        ("cs_list_price", D72), ("cs_sales_price", D72),
        ("cs_ext_discount_amt", D72), ("cs_ext_sales_price", D72),
        ("cs_ext_wholesale_cost", D72), ("cs_ext_list_price", D72),
        ("cs_ext_tax", D72), ("cs_coupon_amt", D72), ("cs_ext_ship_cost", D72),
        ("cs_net_paid", D72), ("cs_net_paid_inc_tax", D72),
        ("cs_net_paid_inc_ship", D72), ("cs_net_paid_inc_ship_tax", D72),
        ("cs_net_profit", D72),
    ),
    "web_sales": _schema(
        ("ws_sold_date_sk", BIGINT), ("ws_sold_time_sk", BIGINT),
        ("ws_ship_date_sk", BIGINT), ("ws_item_sk", BIGINT),
        ("ws_bill_customer_sk", BIGINT), ("ws_bill_cdemo_sk", BIGINT),
        ("ws_bill_hdemo_sk", BIGINT), ("ws_bill_addr_sk", BIGINT),
        ("ws_ship_customer_sk", BIGINT), ("ws_ship_cdemo_sk", BIGINT),
        ("ws_ship_hdemo_sk", BIGINT), ("ws_ship_addr_sk", BIGINT),
        ("ws_web_page_sk", BIGINT), ("ws_web_site_sk", BIGINT),
        ("ws_ship_mode_sk", BIGINT), ("ws_warehouse_sk", BIGINT),
        ("ws_promo_sk", BIGINT), ("ws_order_number", BIGINT),
        ("ws_quantity", INTEGER), ("ws_wholesale_cost", D72),
        ("ws_list_price", D72), ("ws_sales_price", D72),
        ("ws_ext_discount_amt", D72), ("ws_ext_sales_price", D72),
        ("ws_ext_wholesale_cost", D72), ("ws_ext_list_price", D72),
        ("ws_ext_tax", D72), ("ws_coupon_amt", D72), ("ws_ext_ship_cost", D72),
        ("ws_net_paid", D72), ("ws_net_paid_inc_tax", D72),
        ("ws_net_paid_inc_ship", D72), ("ws_net_paid_inc_ship_tax", D72),
        ("ws_net_profit", D72),
    ),
    "store_returns": _schema(
        ("sr_returned_date_sk", BIGINT), ("sr_return_time_sk", BIGINT),
        ("sr_item_sk", BIGINT), ("sr_customer_sk", BIGINT),
        ("sr_cdemo_sk", BIGINT), ("sr_hdemo_sk", BIGINT),
        ("sr_addr_sk", BIGINT), ("sr_store_sk", BIGINT),
        ("sr_reason_sk", BIGINT), ("sr_ticket_number", BIGINT),
        ("sr_return_quantity", INTEGER), ("sr_return_amt", D72),
        ("sr_return_tax", D72), ("sr_return_amt_inc_tax", D72),
        ("sr_fee", D72), ("sr_return_ship_cost", D72),
        ("sr_refunded_cash", D72), ("sr_reversed_charge", D72),
        ("sr_store_credit", D72), ("sr_net_loss", D72),
    ),
    "catalog_returns": _schema(
        ("cr_returned_date_sk", BIGINT), ("cr_returned_time_sk", BIGINT),
        ("cr_item_sk", BIGINT), ("cr_refunded_customer_sk", BIGINT),
        ("cr_refunded_cdemo_sk", BIGINT), ("cr_refunded_hdemo_sk", BIGINT),
        ("cr_refunded_addr_sk", BIGINT), ("cr_returning_customer_sk", BIGINT),
        ("cr_returning_cdemo_sk", BIGINT), ("cr_returning_hdemo_sk", BIGINT),
        ("cr_returning_addr_sk", BIGINT), ("cr_call_center_sk", BIGINT),
        ("cr_catalog_page_sk", BIGINT), ("cr_ship_mode_sk", BIGINT),
        ("cr_warehouse_sk", BIGINT), ("cr_reason_sk", BIGINT),
        ("cr_order_number", BIGINT), ("cr_return_quantity", INTEGER),
        ("cr_return_amount", D72), ("cr_return_tax", D72),
        ("cr_return_amt_inc_tax", D72), ("cr_fee", D72),
        ("cr_return_ship_cost", D72), ("cr_refunded_cash", D72),
        ("cr_reversed_charge", D72), ("cr_store_credit", D72),
        ("cr_net_loss", D72),
    ),
    "web_returns": _schema(
        ("wr_returned_date_sk", BIGINT), ("wr_returned_time_sk", BIGINT),
        ("wr_item_sk", BIGINT), ("wr_refunded_customer_sk", BIGINT),
        ("wr_refunded_cdemo_sk", BIGINT), ("wr_refunded_hdemo_sk", BIGINT),
        ("wr_refunded_addr_sk", BIGINT), ("wr_returning_customer_sk", BIGINT),
        ("wr_returning_cdemo_sk", BIGINT), ("wr_returning_hdemo_sk", BIGINT),
        ("wr_returning_addr_sk", BIGINT), ("wr_web_page_sk", BIGINT),
        ("wr_reason_sk", BIGINT), ("wr_order_number", BIGINT),
        ("wr_return_quantity", INTEGER), ("wr_return_amt", D72),
        ("wr_return_tax", D72), ("wr_return_amt_inc_tax", D72),
        ("wr_fee", D72), ("wr_return_ship_cost", D72),
        ("wr_refunded_cash", D72), ("wr_reversed_charge", D72),
        ("wr_account_credit", D72), ("wr_net_loss", D72),
    ),
})

DICTS.update({
    "warehouse": {"w_warehouse_name": WAREHOUSE_NAMES, "w_street_name": CITIES,
                  "w_street_type": _enum("Street", "Ave"), "w_city": CITIES,
                  "w_suite_number": _enum(*[f"Suite {i}" for i in range(50)]),
                  "w_county": COUNTIES, "w_state": STATES,
                  "w_country": _enum("United States")},
    "ship_mode": {"sm_type": SHIP_TYPES, "sm_code": _enum("AIR", "SURFACE",
                                                          "SEA"),
                  "sm_carrier": CARRIERS,
                  "sm_contract": _enum(*[f"contract{i}" for i in range(20)])},
    "reason": {"r_reason_desc": REASONS},
    "income_band": {},
    "household_demographics": {"hd_buy_potential": BUY_POTENTIAL},
    "time_dim": {"t_am_pm": AMPM, "t_shift": SHIFTS, "t_sub_shift": SHIFTS,
                 "t_meal_time": MEALS},
    "web_site": {"web_name": _enum(*[f"site_{i}" for i in range(30)]),
                 "web_class": _enum("Unknown"), "web_manager": MANAGERS,
                 "web_mkt_class": COUNTIES, "web_mkt_desc": COUNTIES,
                 "web_market_manager": MANAGERS,
                 "web_company_name": STORE_NAMES, "web_street_name": CITIES,
                 "web_street_type": _enum("Street", "Ave"),
                 "web_suite_number": _enum(*[f"Suite {i}" for i in range(50)]),
                 "web_city": CITIES, "web_county": COUNTIES,
                 "web_state": STATES, "web_country": _enum("United States")},
    "web_page": {"wp_autogen_flag": YN, "wp_url": URLS, "wp_type": PAGE_TYPES},
    "call_center": {"cc_name": CC_NAMES, "cc_class": CC_CLASSES,
                    "cc_hours": _enum("8AM-8PM", "8AM-4PM", "8AM-12AM"),
                    "cc_manager": MANAGERS, "cc_mkt_class": COUNTIES,
                    "cc_mkt_desc": COUNTIES, "cc_market_manager": MANAGERS,
                    "cc_division_name": STORE_NAMES,
                    "cc_company_name": STORE_NAMES, "cc_street_name": CITIES,
                    "cc_street_type": _enum("Street", "Ave"),
                    "cc_suite_number": _enum(*[f"Suite {i}"
                                               for i in range(50)]),
                    "cc_city": CITIES, "cc_county": COUNTIES,
                    "cc_state": STATES, "cc_country": _enum("United States")},
    "catalog_page": {"cp_department": DEPARTMENTS, "cp_description": ITEM_IDS,
                     "cp_type": CATALOG_TYPES},
    "inventory": {}, "catalog_sales": {}, "web_sales": {},
    "store_returns": {}, "catalog_returns": {}, "web_returns": {},
})


def _scaled_rows(table: str, sf: float) -> int:
    """The ONE row-count rule (shared by row_count and FK domains, so a ratio
    edit can never leave dangling foreign keys)."""
    if table in FIXED_ROWS:
        return FIXED_ROWS[table]
    if table in MIN_SCALED:
        return max(int(round(BASE_ROWS[table] * max(sf, MIN_SCALED[table]))), 1)
    return max(int(BASE_ROWS[table] * sf), 1)


def _fk_counts(sf):
    """Scaled FK domain sizes shared by every fact generator."""
    return {
        "item": _scaled_rows("item", sf),
        "customer": _scaled_rows("customer", sf),
        "addr": _scaled_rows("customer_address", sf),
        "store": _scaled_rows("store", sf),
        "promo": _scaled_rows("promotion", sf),
        "warehouse": _scaled_rows("warehouse", sf),
        "web_page": _scaled_rows("web_page", sf),
        "web_site": _scaled_rows("web_site", sf),
        "cc": _scaled_rows("call_center", sf),
        "cp": _scaled_rows("catalog_page", sf),
        "hd": FIXED_ROWS["household_demographics"],
        "ship_mode": FIXED_ROWS["ship_mode"],
        "reason": FIXED_ROWS["reason"],
    }


def _sale_measures(seed, i):
    """The shared pricing waterfall every sales channel applies (quantities,
    list/sales prices, extensions, tax, coupon, net) — cents-scaled ints."""
    qty = _uniform(seed, i, 1, 100).to(torch.int32)
    wholesale = _uniform(seed + 1, i, 100, 10000)
    markup = _uniform(seed + 2, i, 100, 200)
    list_price = (wholesale * markup) // 100
    discount = _uniform(seed + 3, i, 0, 90)
    sales_price = (list_price * (100 - discount)) // 100
    q64 = qty.to(torch.int64)
    ext_list = list_price * q64
    ext_sales = sales_price * q64
    ext_wholesale = wholesale * q64
    tax = (ext_sales * 8) // 100
    coupon = torch.where(_uniform(seed + 4, i, 0, 9) == 0, ext_sales // 10, 0)
    ship = (ext_sales * _uniform(seed + 5, i, 0, 20)) // 100
    net_paid = ext_sales - coupon
    return {
        "quantity": qty, "wholesale_cost": wholesale,
        "list_price": list_price, "sales_price": sales_price,
        "ext_discount_amt": ext_list - ext_sales,
        "ext_sales_price": ext_sales, "ext_wholesale_cost": ext_wholesale,
        "ext_list_price": ext_list, "ext_tax": tax, "coupon_amt": coupon,
        "ext_ship_cost": ship, "net_paid": net_paid,
        "net_paid_inc_tax": net_paid + tax,
        "net_paid_inc_ship": net_paid + ship,
        "net_paid_inc_ship_tax": net_paid + ship + tax,
        "net_profit": net_paid - ext_wholesale,
    }


def _return_measures(seed, i):
    qty = _uniform(seed, i, 1, 20).to(torch.int32)
    amt = _uniform(seed + 1, i, 100, 20000) * qty.to(torch.int64)
    tax = (amt * 8) // 100
    fee = _uniform(seed + 2, i, 50, 10000)
    ship = (amt * _uniform(seed + 3, i, 0, 20)) // 100
    cash = (amt * _uniform(seed + 4, i, 0, 100)) // 100
    reversed_c = (amt - cash) // 2
    credit = amt - cash - reversed_c
    return {"quantity": qty, "amt": amt, "tax": tax,
            "amt_inc_tax": amt + tax, "fee": fee, "ship": ship,
            "cash": cash, "reversed": reversed_c, "credit": credit,
            "loss": amt + tax + fee + ship - cash}


def gen_warehouse(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "w_warehouse_sk": lambda: sk, "w_warehouse_id": lambda: sk,
        "w_warehouse_name": lambda: (i % 5).to(torch.int32),
        "w_warehouse_sq_ft": lambda: _uniform(2001, i, 50_000, 1_000_000).to(torch.int32),
        "w_street_number": lambda: _uniform(2002, i, 1, 999).to(torch.int32),
        "w_street_name": lambda: (i % 200).to(torch.int32),
        "w_street_type": lambda: (i % 2).to(torch.int32),
        "w_suite_number": lambda: (i % 50).to(torch.int32),
        "w_city": lambda: (i % 200).to(torch.int32),
        "w_county": lambda: (i % 10).to(torch.int32),
        "w_state": lambda: (i % 10).to(torch.int32),
        "w_zip": lambda: _uniform(2003, i, 10000, 99999).to(torch.int32),
        "w_country": lambda: _full(length, 0, device),
        "w_gmt_offset": lambda: _full(length, -500, device),
    })


def gen_ship_mode(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "sm_ship_mode_sk": lambda: sk, "sm_ship_mode_id": lambda: sk,
        "sm_type": lambda: (i % 5).to(torch.int32),
        "sm_code": lambda: (i % 3).to(torch.int32),
        "sm_carrier": lambda: (i % 10).to(torch.int32),
        "sm_contract": lambda: (i % 20).to(torch.int32),
    })


def gen_reason(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({"r_reason_sk": lambda: sk, "r_reason_id": lambda: sk,
            "r_reason_desc": lambda: (i % 35).to(torch.int32)})


def gen_income_band(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({"ib_income_band_sk": lambda: sk,
            "ib_lower_bound": lambda: (i * 10_000).to(torch.int32),
            "ib_upper_bound": lambda: ((i + 1) * 10_000).to(torch.int32)})


def gen_household_demographics(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "hd_demo_sk": lambda: sk,
        "hd_income_band_sk": lambda: (i % 20) + 1,
        "hd_buy_potential": lambda: (i // 20 % 6).to(torch.int32),
        "hd_dep_count": lambda: (i // 120 % 10).to(torch.int32),
        "hd_vehicle_count": lambda: (i // 1200 % 6).to(torch.int32),
    })


def gen_time_dim(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    hour = (i // 3600).to(torch.int32)
    return _Columns({
        "t_time_sk": lambda: i, "t_time_id": lambda: i, "t_time": lambda: i.to(torch.int32),
        "t_hour": lambda: hour,
        "t_minute": lambda: ((i // 60) % 60).to(torch.int32),
        "t_second": lambda: (i % 60).to(torch.int32),
        "t_am_pm": lambda: (hour >= 12).to(torch.int32),
        "t_shift": lambda: (hour // 8).to(torch.int32) % 3,
        "t_sub_shift": lambda: ((hour + 4) // 8).to(torch.int32) % 3,
        "t_meal_time": lambda: torch.where(
            (hour >= 6) & (hour <= 9), 0,
            torch.where((hour >= 11) & (hour <= 14), 1,
                      torch.where((hour >= 17) & (hour <= 21), 2, 3))
        ).to(torch.int32),
    })


def gen_web_site(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "web_site_sk": lambda: sk, "web_site_id": lambda: sk,
        "web_rec_start_date": lambda: _full(length, DATE_LO, device),
        "web_rec_end_date": lambda: _full(length, DATE_HI, device),
        "web_name": lambda: (i % 30).to(torch.int32),
        "web_open_date_sk": lambda: JULIAN_BASE + _uniform(2101, i, 0, N_DATES - 1),
        "web_close_date_sk": lambda: JULIAN_BASE + N_DATES - 1 + _full(length, 0, device),
        "web_class": lambda: _full(length, 0, device),
        "web_manager": lambda: (i % 100).to(torch.int32),
        "web_mkt_id": lambda: _uniform(2102, i, 1, 6).to(torch.int32),
        "web_mkt_class": lambda: (i % 10).to(torch.int32),
        "web_mkt_desc": lambda: (i % 10).to(torch.int32),
        "web_market_manager": lambda: (i % 100).to(torch.int32),
        "web_company_id": lambda: _uniform(2103, i, 1, 6).to(torch.int32),
        "web_company_name": lambda: (i % 12).to(torch.int32),
        "web_street_number": lambda: _uniform(2104, i, 1, 999).to(torch.int32),
        "web_street_name": lambda: (i % 200).to(torch.int32),
        "web_street_type": lambda: (i % 2).to(torch.int32),
        "web_suite_number": lambda: (i % 50).to(torch.int32),
        "web_city": lambda: (i % 200).to(torch.int32),
        "web_county": lambda: (i % 10).to(torch.int32),
        "web_state": lambda: (i % 10).to(torch.int32),
        "web_zip": lambda: _uniform(2105, i, 10000, 99999).to(torch.int32),
        "web_country": lambda: _full(length, 0, device),
        "web_gmt_offset": lambda: _full(length, -500, device),
        "web_tax_percentage": lambda: _uniform(2106, i, 0, 12),
    })


def gen_web_page(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "wp_web_page_sk": lambda: sk, "wp_web_page_id": lambda: sk,
        "wp_rec_start_date": lambda: _full(length, DATE_LO, device),
        "wp_rec_end_date": lambda: _full(length, DATE_HI, device),
        "wp_creation_date_sk": lambda: JULIAN_BASE + _uniform(2201, i, 0, N_DATES - 1),
        "wp_access_date_sk": lambda: JULIAN_BASE + _uniform(2202, i, 0, N_DATES - 1),
        "wp_autogen_flag": lambda: (i % 2).to(torch.int32),
        "wp_customer_sk": lambda: _uniform(2203, i, 1, _fk_counts(sf)["customer"]),
        "wp_url": lambda: (i % 2).to(torch.int32),
        "wp_type": lambda: (i % 7).to(torch.int32),
        "wp_char_count": lambda: _uniform(2204, i, 100, 8000).to(torch.int32),
        "wp_link_count": lambda: _uniform(2205, i, 2, 25).to(torch.int32),
        "wp_image_count": lambda: _uniform(2206, i, 1, 7).to(torch.int32),
        "wp_max_ad_count": lambda: _uniform(2207, i, 0, 4).to(torch.int32),
    })


def gen_call_center(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    return _Columns({
        "cc_call_center_sk": lambda: sk, "cc_call_center_id": lambda: sk,
        "cc_rec_start_date": lambda: _full(length, DATE_LO, device),
        "cc_rec_end_date": lambda: _full(length, DATE_HI, device),
        "cc_closed_date_sk": lambda: _full(length, 0, device),
        "cc_open_date_sk": lambda: JULIAN_BASE + _uniform(2301, i, 0, N_DATES - 1),
        "cc_name": lambda: (i % 6).to(torch.int32),
        "cc_class": lambda: (i % 3).to(torch.int32),
        "cc_employees": lambda: _uniform(2302, i, 1, 7).to(torch.int32),
        "cc_sq_ft": lambda: _uniform(2303, i, 1_000, 700_000).to(torch.int32),
        "cc_hours": lambda: (i % 3).to(torch.int32),
        "cc_manager": lambda: (i % 100).to(torch.int32),
        "cc_mkt_id": lambda: _uniform(2304, i, 1, 6).to(torch.int32),
        "cc_mkt_class": lambda: (i % 10).to(torch.int32),
        "cc_mkt_desc": lambda: (i % 10).to(torch.int32),
        "cc_market_manager": lambda: (i % 100).to(torch.int32),
        "cc_division": lambda: _uniform(2305, i, 1, 6).to(torch.int32),
        "cc_division_name": lambda: (i % 12).to(torch.int32),
        "cc_company": lambda: _uniform(2306, i, 1, 6).to(torch.int32),
        "cc_company_name": lambda: (i % 12).to(torch.int32),
        "cc_street_number": lambda: _uniform(2307, i, 1, 999).to(torch.int32),
        "cc_street_name": lambda: (i % 200).to(torch.int32),
        "cc_street_type": lambda: (i % 2).to(torch.int32),
        "cc_suite_number": lambda: (i % 50).to(torch.int32),
        "cc_city": lambda: (i % 200).to(torch.int32),
        "cc_county": lambda: (i % 10).to(torch.int32),
        "cc_state": lambda: (i % 10).to(torch.int32),
        "cc_zip": lambda: _uniform(2308, i, 10000, 99999).to(torch.int32),
        "cc_country": lambda: _full(length, 0, device),
        "cc_gmt_offset": lambda: _full(length, -500, device),
        "cc_tax_percentage": lambda: _full(length, 0, device),
    })


def gen_catalog_page(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    sk = i + 1
    start = JULIAN_BASE + _uniform(2401, i, 0, N_DATES - 100)
    return _Columns({
        "cp_catalog_page_sk": lambda: sk, "cp_catalog_page_id": lambda: sk,
        "cp_start_date_sk": lambda: start,
        "cp_end_date_sk": lambda: start + 90,
        "cp_department": lambda: _full(length, 0, device),
        "cp_catalog_number": lambda: (i // 108 + 1).to(torch.int32),
        "cp_catalog_page_number": lambda: (i % 108 + 1).to(torch.int32),
        "cp_description": lambda: (i % BASE_ROWS["item"]).to(torch.int32),
        "cp_type": lambda: (i % 3).to(torch.int32),
    })


def gen_inventory(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    fk = _fk_counts(sf)
    n_item, n_wh = fk["item"], fk["warehouse"]
    # weekly snapshots: row = (week, item, warehouse) in row-major order
    per_week = n_item * n_wh
    return _Columns({
        "inv_date_sk": lambda: JULIAN_BASE + (i // per_week) * 7,
        "inv_item_sk": lambda: (i // n_wh) % n_item + 1,
        "inv_warehouse_sk": lambda: i % n_wh + 1,
        "inv_quantity_on_hand": lambda: _uniform(2501, i, 0, 1000).to(torch.int32),
    })


def gen_catalog_sales(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    fk = _fk_counts(sf)
    m = _once(lambda: _sale_measures(2600, i))
    sold = _once(lambda: JULIAN_BASE + _seasonal_date(2610, i))
    return _Columns({
        "cs_sold_date_sk": lambda: sold(),
        "cs_sold_time_sk": lambda: _uniform(2611, i, 28800, 75600),
        "cs_ship_date_sk": lambda: torch.clamp(sold() + _uniform(2612, i, 2, 90),
                                       max=JULIAN_BASE + N_DATES - 1),
        "cs_bill_customer_sk": lambda: _uniform(2613, i, 1, fk["customer"]),
        "cs_bill_cdemo_sk": lambda: _uniform(2614, i, 1, CD_ROWS),
        "cs_bill_hdemo_sk": lambda: _uniform(2615, i, 1, fk["hd"]),
        "cs_bill_addr_sk": lambda: _uniform(2616, i, 1, fk["addr"]),
        "cs_ship_customer_sk": lambda: _uniform(2617, i, 1, fk["customer"]),
        "cs_ship_cdemo_sk": lambda: _uniform(2618, i, 1, CD_ROWS),
        "cs_ship_hdemo_sk": lambda: _uniform(2619, i, 1, fk["hd"]),
        "cs_ship_addr_sk": lambda: _uniform(2620, i, 1, fk["addr"]),
        "cs_call_center_sk": lambda: _uniform(2621, i, 1, fk["cc"]),
        "cs_catalog_page_sk": lambda: _uniform(2622, i, 1, fk["cp"]),
        "cs_ship_mode_sk": lambda: _uniform(2623, i, 1, fk["ship_mode"]),
        "cs_warehouse_sk": lambda: _uniform(2624, i, 1, fk["warehouse"]),
        "cs_item_sk": lambda: _uniform(2625, i, 1, fk["item"]),
        "cs_promo_sk": lambda: _uniform(2626, i, 1, fk["promo"]),
        "cs_order_number": lambda: i // 10 + 1,
        "cs_quantity": lambda: m()["quantity"],
        "cs_wholesale_cost": lambda: m()["wholesale_cost"],
        "cs_list_price": lambda: m()["list_price"],
        "cs_sales_price": lambda: m()["sales_price"],
        "cs_ext_discount_amt": lambda: m()["ext_discount_amt"],
        "cs_ext_sales_price": lambda: m()["ext_sales_price"],
        "cs_ext_wholesale_cost": lambda: m()["ext_wholesale_cost"],
        "cs_ext_list_price": lambda: m()["ext_list_price"],
        "cs_ext_tax": lambda: m()["ext_tax"],
        "cs_coupon_amt": lambda: m()["coupon_amt"],
        "cs_ext_ship_cost": lambda: m()["ext_ship_cost"],
        "cs_net_paid": lambda: m()["net_paid"],
        "cs_net_paid_inc_tax": lambda: m()["net_paid_inc_tax"],
        "cs_net_paid_inc_ship": lambda: m()["net_paid_inc_ship"],
        "cs_net_paid_inc_ship_tax": lambda: m()["net_paid_inc_ship_tax"],
        "cs_net_profit": lambda: m()["net_profit"],
    })


def gen_web_sales(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    fk = _fk_counts(sf)
    m = _once(lambda: _sale_measures(2700, i))
    sold = _once(lambda: JULIAN_BASE + _seasonal_date(2710, i))
    return _Columns({
        "ws_sold_date_sk": lambda: sold(),
        "ws_sold_time_sk": lambda: _uniform(2711, i, 0, 86399),
        "ws_ship_date_sk": lambda: torch.clamp(sold() + _uniform(2712, i, 1, 30),
                                       max=JULIAN_BASE + N_DATES - 1),
        "ws_item_sk": lambda: _uniform(2713, i, 1, fk["item"]),
        "ws_bill_customer_sk": lambda: _uniform(2714, i, 1, fk["customer"]),
        "ws_bill_cdemo_sk": lambda: _uniform(2715, i, 1, CD_ROWS),
        "ws_bill_hdemo_sk": lambda: _uniform(2716, i, 1, fk["hd"]),
        "ws_bill_addr_sk": lambda: _uniform(2717, i, 1, fk["addr"]),
        "ws_ship_customer_sk": lambda: _uniform(2718, i, 1, fk["customer"]),
        "ws_ship_cdemo_sk": lambda: _uniform(2719, i, 1, CD_ROWS),
        "ws_ship_hdemo_sk": lambda: _uniform(2720, i, 1, fk["hd"]),
        "ws_ship_addr_sk": lambda: _uniform(2721, i, 1, fk["addr"]),
        "ws_web_page_sk": lambda: _uniform(2722, i, 1, fk["web_page"]),
        "ws_web_site_sk": lambda: _uniform(2723, i, 1, fk["web_site"]),
        "ws_ship_mode_sk": lambda: _uniform(2724, i, 1, fk["ship_mode"]),
        "ws_warehouse_sk": lambda: _uniform(2725, i, 1, fk["warehouse"]),
        "ws_promo_sk": lambda: _uniform(2726, i, 1, fk["promo"]),
        "ws_order_number": lambda: i // 8 + 1,
        "ws_quantity": lambda: m()["quantity"],
        "ws_wholesale_cost": lambda: m()["wholesale_cost"],
        "ws_list_price": lambda: m()["list_price"],
        "ws_sales_price": lambda: m()["sales_price"],
        "ws_ext_discount_amt": lambda: m()["ext_discount_amt"],
        "ws_ext_sales_price": lambda: m()["ext_sales_price"],
        "ws_ext_wholesale_cost": lambda: m()["ext_wholesale_cost"],
        "ws_ext_list_price": lambda: m()["ext_list_price"],
        "ws_ext_tax": lambda: m()["ext_tax"],
        "ws_coupon_amt": lambda: m()["coupon_amt"],
        "ws_ext_ship_cost": lambda: m()["ext_ship_cost"],
        "ws_net_paid": lambda: m()["net_paid"],
        "ws_net_paid_inc_tax": lambda: m()["net_paid_inc_tax"],
        "ws_net_paid_inc_ship": lambda: m()["net_paid_inc_ship"],
        "ws_net_paid_inc_ship_tax": lambda: m()["net_paid_inc_ship_tax"],
        "ws_net_profit": lambda: m()["net_profit"],
    })


def gen_store_returns(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    fk = _fk_counts(sf)
    r = _once(lambda: _return_measures(2800, i))
    return _Columns({
        "sr_returned_date_sk": lambda: JULIAN_BASE + _uniform(2810, i, 0, N_DATES - 1),
        "sr_return_time_sk": lambda: _uniform(2811, i, 28800, 75600),
        "sr_item_sk": lambda: _uniform(2812, i, 1, fk["item"]),
        "sr_customer_sk": lambda: _uniform(2813, i, 1, fk["customer"]),
        "sr_cdemo_sk": lambda: _uniform(2814, i, 1, CD_ROWS),
        "sr_hdemo_sk": lambda: _uniform(2815, i, 1, fk["hd"]),
        "sr_addr_sk": lambda: _uniform(2816, i, 1, fk["addr"]),
        "sr_store_sk": lambda: _uniform(2817, i, 1, fk["store"]),
        "sr_reason_sk": lambda: _uniform(2818, i, 1, fk["reason"]),
        "sr_ticket_number": lambda: _uniform(2819, i, 1,
                                     max(int(BASE_ROWS["store_sales"] * sf)
                                         // 12, 1)),
        "sr_return_quantity": lambda: r()["quantity"],
        "sr_return_amt": lambda: r()["amt"],
        "sr_return_tax": lambda: r()["tax"],
        "sr_return_amt_inc_tax": lambda: r()["amt_inc_tax"],
        "sr_fee": lambda: r()["fee"],
        "sr_return_ship_cost": lambda: r()["ship"],
        "sr_refunded_cash": lambda: r()["cash"],
        "sr_reversed_charge": lambda: r()["reversed"],
        "sr_store_credit": lambda: r()["credit"],
        "sr_net_loss": lambda: r()["loss"],
    })


def gen_catalog_returns(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    fk = _fk_counts(sf)
    r = _once(lambda: _return_measures(2900, i))
    return _Columns({
        "cr_returned_date_sk": lambda: JULIAN_BASE + _uniform(2910, i, 0, N_DATES - 1),
        "cr_returned_time_sk": lambda: _uniform(2911, i, 28800, 75600),
        "cr_item_sk": lambda: _uniform(2912, i, 1, fk["item"]),
        "cr_refunded_customer_sk": lambda: _uniform(2913, i, 1, fk["customer"]),
        "cr_refunded_cdemo_sk": lambda: _uniform(2914, i, 1, CD_ROWS),
        "cr_refunded_hdemo_sk": lambda: _uniform(2915, i, 1, fk["hd"]),
        "cr_refunded_addr_sk": lambda: _uniform(2916, i, 1, fk["addr"]),
        "cr_returning_customer_sk": lambda: _uniform(2917, i, 1, fk["customer"]),
        "cr_returning_cdemo_sk": lambda: _uniform(2918, i, 1, CD_ROWS),
        "cr_returning_hdemo_sk": lambda: _uniform(2919, i, 1, fk["hd"]),
        "cr_returning_addr_sk": lambda: _uniform(2920, i, 1, fk["addr"]),
        "cr_call_center_sk": lambda: _uniform(2921, i, 1, fk["cc"]),
        "cr_catalog_page_sk": lambda: _uniform(2922, i, 1, fk["cp"]),
        "cr_ship_mode_sk": lambda: _uniform(2923, i, 1, fk["ship_mode"]),
        "cr_warehouse_sk": lambda: _uniform(2924, i, 1, fk["warehouse"]),
        "cr_reason_sk": lambda: _uniform(2925, i, 1, fk["reason"]),
        "cr_order_number": lambda: _uniform(2926, i, 1,
                                    max(int(BASE_ROWS["catalog_sales"] * sf)
                                        // 10, 1)),
        "cr_return_quantity": lambda: r()["quantity"],
        "cr_return_amount": lambda: r()["amt"],
        "cr_return_tax": lambda: r()["tax"],
        "cr_return_amt_inc_tax": lambda: r()["amt_inc_tax"],
        "cr_fee": lambda: r()["fee"],
        "cr_return_ship_cost": lambda: r()["ship"],
        "cr_refunded_cash": lambda: r()["cash"],
        "cr_reversed_charge": lambda: r()["reversed"],
        "cr_store_credit": lambda: r()["credit"],
        "cr_net_loss": lambda: r()["loss"],
    })


def gen_web_returns(sf, lo, length, n=0, device="cpu"):
    i = _index(lo, length, device)
    fk = _fk_counts(sf)
    r = _once(lambda: _return_measures(3000, i))
    return _Columns({
        "wr_returned_date_sk": lambda: JULIAN_BASE + _uniform(3010, i, 0, N_DATES - 1),
        "wr_returned_time_sk": lambda: _uniform(3011, i, 0, 86399),
        "wr_item_sk": lambda: _uniform(3012, i, 1, fk["item"]),
        "wr_refunded_customer_sk": lambda: _uniform(3013, i, 1, fk["customer"]),
        "wr_refunded_cdemo_sk": lambda: _uniform(3014, i, 1, CD_ROWS),
        "wr_refunded_hdemo_sk": lambda: _uniform(3015, i, 1, fk["hd"]),
        "wr_refunded_addr_sk": lambda: _uniform(3016, i, 1, fk["addr"]),
        "wr_returning_customer_sk": lambda: _uniform(3017, i, 1, fk["customer"]),
        "wr_returning_cdemo_sk": lambda: _uniform(3018, i, 1, CD_ROWS),
        "wr_returning_hdemo_sk": lambda: _uniform(3019, i, 1, fk["hd"]),
        "wr_returning_addr_sk": lambda: _uniform(3020, i, 1, fk["addr"]),
        "wr_web_page_sk": lambda: _uniform(3021, i, 1, fk["web_page"]),
        "wr_reason_sk": lambda: _uniform(3022, i, 1, fk["reason"]),
        "wr_order_number": lambda: _uniform(3023, i, 1,
                                    max(int(BASE_ROWS["web_sales"] * sf)
                                        // 8, 1)),
        "wr_return_quantity": lambda: r()["quantity"],
        "wr_return_amt": lambda: r()["amt"],
        "wr_return_tax": lambda: r()["tax"],
        "wr_return_amt_inc_tax": lambda: r()["amt_inc_tax"],
        "wr_fee": lambda: r()["fee"],
        "wr_return_ship_cost": lambda: r()["ship"],
        "wr_refunded_cash": lambda: r()["cash"],
        "wr_reversed_charge": lambda: r()["reversed"],
        "wr_account_credit": lambda: r()["credit"],
        "wr_net_loss": lambda: r()["loss"],
    })


GENERATORS = {
    "date_dim": gen_date_dim,
    "item": gen_item,
    "customer": gen_customer,
    "customer_address": gen_customer_address,
    "customer_demographics": gen_customer_demographics,
    "store": gen_store,
    "promotion": gen_promotion,
    "store_sales": gen_store_sales,
    "warehouse": gen_warehouse,
    "ship_mode": gen_ship_mode,
    "reason": gen_reason,
    "income_band": gen_income_band,
    "household_demographics": gen_household_demographics,
    "time_dim": gen_time_dim,
    "web_site": gen_web_site,
    "web_page": gen_web_page,
    "call_center": gen_call_center,
    "catalog_page": gen_catalog_page,
    "inventory": gen_inventory,
    "catalog_sales": gen_catalog_sales,
    "web_sales": gen_web_sales,
    "store_returns": gen_store_returns,
    "catalog_returns": gen_catalog_returns,
    "web_returns": gen_web_returns,
}

_PK = {"date_dim": ("d_date_sk",), "item": ("i_item_sk",),
       "customer": ("c_customer_sk",), "customer_address": ("ca_address_sk",),
       "customer_demographics": ("cd_demo_sk",), "store": ("s_store_sk",),
       "promotion": ("p_promo_sk",), "warehouse": ("w_warehouse_sk",),
       "ship_mode": ("sm_ship_mode_sk",), "reason": ("r_reason_sk",),
       "income_band": ("ib_income_band_sk",),
       "household_demographics": ("hd_demo_sk",), "time_dim": ("t_time_sk",),
       "web_site": ("web_site_sk",), "web_page": ("wp_web_page_sk",),
       "call_center": ("cc_call_center_sk",),
       "catalog_page": ("cp_catalog_page_sk",)}

_MONOTONE_PK = {t: pk[0] for t, pk in _PK.items()}
# monotone-pk base offset: most sks start at 1; date_dim's is julian-like and
# time_dim's counts seconds from 0
_PK_BASE = {t: 1 for t in _PK}
_PK_BASE["date_dim"] = JULIAN_BASE
_PK_BASE["time_dim"] = 0


@dataclasses.dataclass(frozen=True)
class TpcdsSplit:
    table: str
    lo: int
    hi: int


class TpcdsConnector:
    """Connector over generated TPC-DS data."""

    name = "tpcds"
    supports_count_pushdown = True  # row counts are index-derived (exact)
    CACHEABLE_SCANS = True  # deterministic generator (see TpchConnector)

    def __init__(self, sf: float = 1.0, split_rows: int = 1 << 20, device=None):
        self.sf = sf
        self.split_rows = split_rows
        # device the pages are generated on; None = the device of the engine
        # this connector is registered with (Engine.register_catalog binds it)
        self.device = device

    def exact_row_count(self, table: str) -> int:
        return self.row_count(table)

    def tables(self):
        return sorted(SCHEMAS)

    def schema(self, table: str) -> Schema:
        return SCHEMAS[table]

    def dictionaries(self, table: str) -> dict:
        return dict(DICTS[table])

    def primary_key(self, table: str) -> tuple:
        if table in _PK:
            return _PK[table]
        raise KeyError(table)

    def row_count(self, table: str) -> int:
        if table == "date_dim":
            return N_DATES
        if table == "customer_demographics":
            return CD_ROWS
        return _scaled_rows(table, self.sf)

    def column_range(self, table: str, column: str):
        pk = _MONOTONE_PK.get(table)
        if pk == column:
            base = _PK_BASE[table]
            return (base, base + self.row_count(table) - 1)
        return (None, None)

    def splits(self, table: str, n_hint: int = 0):
        """Equal-size split ranges; the trailing overshoot past
        ``row_count`` is masked by the page's valid mask (the TPC-H
        connector's contract)."""
        n = self.row_count(table)
        step = min(self.split_rows, max(n, 1))
        nsplits = -(-n // step)
        if n_hint:
            nsplits = -(-nsplits // n_hint) * n_hint  # a multiple of n_hint
        return [TpcdsSplit(table, s * step, (s + 1) * step)
                for s in range(nsplits)]

    def split_range(self, split: TpcdsSplit, column: str):
        """(min, max) of a monotone primary key within a split, else None
        (split pruning against pushed-down and dynamic-filter domains)."""
        pk = _MONOTONE_PK.get(split.table)
        if pk == column:
            base = _PK_BASE[split.table]
            return (base + split.lo, base + split.hi - 1)
        return None

    def _device(self):
        return torch.device(self.device if self.device is not None else "cpu")

    def generate(self, split: TpcdsSplit, columns=None) -> Page:
        """One split's page, generated on the connector's device."""
        schema = SCHEMAS[split.table]
        names = tuple(columns) if columns is not None else schema.names
        n = self.row_count(split.table)
        cols, valid = self.generate_traced(split.table, split.lo, split.hi - split.lo,
                                           names)
        if split.hi <= n:
            valid = None
        out_schema = Schema(tuple(schema.field(c) for c in names))
        return Page(out_schema, cols, tuple(None for _ in cols), valid)

    def generate_traced(self, table: str, lo, length: int, columns):
        """Rows [lo, lo + length) of ``columns`` and their valid mask (rows
        past the table's end are invalid): (cols tuple, valid).  ``lo`` is a
        host int or a 0-d int64 tensor on the device, read on the device
        only."""
        all_cols = GENERATORS[table](self.sf, lo, length, device=self._device())
        schema = SCHEMAS[table]
        cols = tuple(all_cols[c].to(torch_dtype(schema.field(c).type)) for c in columns)
        valid = _index(lo, length, self._device()) < self.row_count(table)
        return cols, valid
