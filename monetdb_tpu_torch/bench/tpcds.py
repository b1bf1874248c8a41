"""TPC-DS subset — generator, schema, and 15 representative queries.

The reference ships TPC-DS as a benchmark suite (sql/benchmarks/tpcds/:
full 24-table DDL + the 99 queries in sqllogictest form,
Tests/one.test.in). Here: the store_sales star (10 tables) with a seeded
vectorized generator in the *physical* domain (money as integer cents,
date keys as dense ints), so identical arrays load into the engine and
the sqlite oracle and rows compare exactly — the same pattern as
bench/ssbm.py.

Queries follow the official templates (sql/benchmarks/tpcds/
Tests/one.test.in query blocks), restricted to the generated columns and
physical types: Q3 Q7 Q19 Q42 Q43 Q52 Q53 Q55 Q65 Q68 Q73 Q79 Q89 Q96
Q98 — star joins, CASE-pivot aggregation, derived-table self-joins, and
window-functions-over-aggregates (avg(sum(..)) OVER).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["gen_tpcds", "load_tpcds", "QUERIES", "SCHEMA"]

CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Music",
              "Shoes", "Sports", "Women", "Men", "Children"]
CLASSES_PER_CAT = 4
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
CITIES = ["Midway", "Fairview", "Oakland", "Salem", "Georgetown",
          "Ashland", "Marion", "Clinton", "Greenville", "Riverside"]
STATES = ["TN", "CA", "TX", "OH", "GA", "SC", "OR", "WA", "NY", "IL"]
FIRST = ["James", "Mary", "John", "Linda", "Robert", "Susan", "David",
         "Karen", "Paul", "Nancy", "Mark", "Lisa"]
LAST = ["Smith", "Johnson", "Brown", "Jones", "Miller", "Davis",
        "Wilson", "Moore", "Taylor", "White", "Clark", "Lewis"]


def _pick(rng, pool, n):
    return np.array(pool, dtype=object)[rng.integers(0, len(pool), n)] \
        .astype(str)


def gen_tpcds(n_store_sales: int = 40_000, seed: int = 13) \
        -> Dict[str, Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)

    # -- date_dim: 1998-01-01 .. 2002-12-31, dense surrogate keys --------
    days = np.arange(np.datetime64("1998-01-01"), np.datetime64("2003-01-01"))
    nd = len(days)
    y = days.astype("datetime64[Y]").astype(int) + 1970
    m = days.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (days - days.astype("datetime64[M]")).astype(int) + 1
    dow = (days.astype("datetime64[D]").astype(int) + 4) % 7  # 1970-01-01=Thu
    date_dim = {
        "d_date_sk": np.arange(1, nd + 1, dtype=np.int64),
        "d_year": y.astype(np.int64),
        "d_moy": m.astype(np.int64),
        "d_dom": dom.astype(np.int64),
        "d_qoy": ((m - 1) // 3 + 1).astype(np.int64),
        "d_day_name": np.array([DAY_NAMES[d] for d in dow]),
        "d_month_seq": ((y - 1998) * 12 + m - 1 + 1176).astype(np.int64),
    }

    # -- time_dim: one row per minute of day ------------------------------
    mins = np.arange(24 * 60)
    time_dim = {
        "t_time_sk": (mins + 1).astype(np.int64),
        "t_hour": (mins // 60).astype(np.int64),
        "t_minute": (mins % 60).astype(np.int64),
    }

    ni = max(n_store_sales // 40, 200)
    cat_i = rng.integers(0, len(CATEGORIES), ni)
    class_i = rng.integers(0, CLASSES_PER_CAT, ni)
    brand_i = rng.integers(1, 11, ni)
    manu = rng.integers(1, 101, ni)
    item = {
        "i_item_sk": np.arange(1, ni + 1, dtype=np.int64),
        "i_item_id": np.array([f"ITEM{k:012d}" for k in range(1, ni + 1)]),
        "i_item_desc": np.array([f"desc of item {k}"
                                 for k in range(1, ni + 1)]),
        "i_brand_id": (cat_i * 1000 + brand_i * 10 + 1).astype(np.int64),
        "i_brand": np.array([f"brand#{c}{b}"
                             for c, b in zip(cat_i, brand_i)]),
        "i_class_id": (class_i + 1).astype(np.int64),
        "i_class": np.array([f"class{c}{k}"
                             for c, k in zip(cat_i, class_i)]),
        "i_category_id": (cat_i + 1).astype(np.int64),
        "i_category": np.array([CATEGORIES[c] for c in cat_i]),
        "i_manufact_id": manu.astype(np.int64),
        "i_manufact": np.array([f"manufact#{v}" for v in manu]),
        "i_manager_id": rng.integers(1, 101, ni).astype(np.int64),
        "i_current_price": rng.integers(99, 10000, ni).astype(np.int64),
        "i_wholesale_cost": rng.integers(50, 6000, ni).astype(np.int64),
    }

    nca = max(n_store_sales // 50, 100)
    customer_address = {
        "ca_address_sk": np.arange(1, nca + 1, dtype=np.int64),
        "ca_city": _pick(rng, CITIES, nca),
        "ca_state": _pick(rng, STATES, nca),
        "ca_zip": np.array([f"{z:05d}" for z in rng.integers(10000, 99999,
                                                             nca)]),
        "ca_country": np.array(["United States"] * nca),
    }

    ncd = len(GENDERS) * len(MARITAL) * len(EDUCATION)
    g_, m_, e_ = np.meshgrid(np.arange(len(GENDERS)),
                             np.arange(len(MARITAL)),
                             np.arange(len(EDUCATION)), indexing="ij")
    customer_demographics = {
        "cd_demo_sk": np.arange(1, ncd + 1, dtype=np.int64),
        "cd_gender": np.array([GENDERS[i] for i in g_.ravel()]),
        "cd_marital_status": np.array([MARITAL[i] for i in m_.ravel()]),
        "cd_education_status": np.array([EDUCATION[i] for i in e_.ravel()]),
        "cd_dep_count": rng.integers(0, 7, ncd).astype(np.int64),
    }

    nhd = 60
    household_demographics = {
        "hd_demo_sk": np.arange(1, nhd + 1, dtype=np.int64),
        "hd_dep_count": rng.integers(0, 10, nhd).astype(np.int64),
        "hd_buy_potential": _pick(rng, BUY_POTENTIAL, nhd),
        "hd_vehicle_count": rng.integers(0, 5, nhd).astype(np.int64),
    }

    nc = max(n_store_sales // 30, 150)
    customer = {
        "c_customer_sk": np.arange(1, nc + 1, dtype=np.int64),
        "c_customer_id": np.array([f"CUST{k:012d}"
                                   for k in range(1, nc + 1)]),
        "c_first_name": _pick(rng, FIRST, nc),
        "c_last_name": _pick(rng, LAST, nc),
        "c_current_cdemo_sk": rng.integers(1, ncd + 1, nc).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, nhd + 1, nc).astype(np.int64),
        "c_current_addr_sk": rng.integers(1, nca + 1, nc).astype(np.int64),
    }

    ns = 12
    store = {
        "s_store_sk": np.arange(1, ns + 1, dtype=np.int64),
        "s_store_id": np.array([f"ST{k:08d}" for k in range(1, ns + 1)]),
        "s_store_name": _pick(rng, ["ought", "able", "ese", "anti", "cally",
                                    "ation", "eing", "bar"], ns),
        "s_city": _pick(rng, CITIES[:5], ns),
        "s_county": _pick(rng, ["Williamson County", "Ziebach County",
                                "Walker County", "Daviess County"], ns),
        "s_state": _pick(rng, STATES[:5], ns),
        "s_zip": np.array([f"{z:05d}" for z in rng.integers(10000, 99999,
                                                            ns)]),
        "s_number_employees": rng.integers(200, 301, ns).astype(np.int64),
        "s_gmt_offset": np.full(ns, -5, dtype=np.int64),
    }

    npm = 30
    yn = np.array(["Y", "N"], dtype=object)
    promotion = {
        "p_promo_sk": np.arange(1, npm + 1, dtype=np.int64),
        "p_channel_dmail": yn[rng.integers(0, 2, npm)].astype(str),
        "p_channel_email": yn[rng.integers(0, 2, npm)].astype(str),
        "p_channel_event": yn[rng.integers(0, 2, npm)].astype(str),
        "p_channel_tv": yn[rng.integers(0, 2, npm)].astype(str),
    }

    n = n_store_sales
    qty = rng.integers(1, 101, n).astype(np.int64)
    list_price = item["i_current_price"][
        rng.integers(0, ni, n)] + rng.integers(0, 200, n)
    sales_price = (list_price * rng.integers(30, 101, n)) // 100
    ext_sales = sales_price * qty
    ext_list = list_price * qty
    wholesale = (list_price * rng.integers(20, 70, n)) // 100
    ext_wholesale = wholesale * qty
    coupon = np.where(rng.random(n) < 0.1,
                      rng.integers(0, 500, n), 0).astype(np.int64)
    net_paid = ext_sales - coupon
    store_sales = {
        "ss_sold_date_sk": rng.integers(1, nd + 1, n).astype(np.int64),
        "ss_sold_time_sk": rng.integers(1, 24 * 60 + 1, n).astype(np.int64),
        "ss_item_sk": rng.integers(1, ni + 1, n).astype(np.int64),
        "ss_customer_sk": rng.integers(1, nc + 1, n).astype(np.int64),
        "ss_cdemo_sk": rng.integers(1, ncd + 1, n).astype(np.int64),
        "ss_hdemo_sk": rng.integers(1, nhd + 1, n).astype(np.int64),
        "ss_addr_sk": rng.integers(1, nca + 1, n).astype(np.int64),
        "ss_store_sk": rng.integers(1, ns + 1, n).astype(np.int64),
        "ss_promo_sk": rng.integers(1, npm + 1, n).astype(np.int64),
        "ss_ticket_number": (np.arange(n, dtype=np.int64) // 4 + 1),
        "ss_quantity": qty,
        "ss_list_price": list_price.astype(np.int64),
        "ss_sales_price": sales_price.astype(np.int64),
        "ss_ext_sales_price": ext_sales.astype(np.int64),
        "ss_ext_list_price": ext_list.astype(np.int64),
        "ss_ext_wholesale_cost": ext_wholesale.astype(np.int64),
        "ss_coupon_amt": coupon,
        "ss_net_paid": net_paid.astype(np.int64),
        "ss_net_profit": (net_paid - ext_wholesale).astype(np.int64),
    }
    return {"date_dim": date_dim, "time_dim": time_dim, "item": item,
            "customer": customer, "customer_address": customer_address,
            "customer_demographics": customer_demographics,
            "household_demographics": household_demographics,
            "store": store, "promotion": promotion,
            "store_sales": store_sales}


def _schema_of(data):
    return {t: {c: ("i64" if a.dtype.kind in "iu" else "str")
                for c, a in cols.items()} for t, cols in data.items()}


SCHEMA = _schema_of(gen_tpcds(64, seed=13))


def load_tpcds(n_store_sales: int = 40_000, seed: int = 13, *,
               device="cuda"):
    """Generated arrays → engine Catalog with every column on ``device``:
    the card unless the caller names another device (property derivation
    as in the TPC-H loader)."""
    from ..table import Catalog, Table
    from .tpch_load import make_column
    data = gen_tpcds(n_store_sales, seed)
    cat = Catalog()
    for tname, cols in data.items():
        dev = {cname: make_column(arr, SCHEMA[tname][cname], device)
               for cname, arr in cols.items()}
        cat.add(Table.from_dict(tname, dev))
    return cat, data


QUERIES = {
    # star join + month filter (official query3)
    "3": """select d_year, i_brand_id, i_brand,
        sum(ss_ext_sales_price) as sum_agg
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
        and i_manufact_id = 52 and d_moy = 11
        group by d_year, i_brand_id, i_brand
        order by d_year, sum_agg desc, i_brand_id limit 100""",
    # demographics + promotion star with 4 AVGs (official query7)
    "7": """select i_item_id, avg(ss_quantity) as agg1,
        avg(ss_list_price) as agg2, avg(ss_coupon_amt) as agg3,
        avg(ss_sales_price) as agg4
        from store_sales, customer_demographics, date_dim, item, promotion
        where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
        and ss_cdemo_sk = cd_demo_sk and ss_promo_sk = p_promo_sk
        and cd_gender = 'M' and cd_marital_status = 'S'
        and cd_education_status = 'College'
        and (p_channel_email = 'N' or p_channel_event = 'N')
        and d_year = 2000
        group by i_item_id order by i_item_id limit 100""",
    # 6-way star, zip-prefix mismatch predicate (official query19)
    "19": """select i_brand_id, i_brand, i_manufact_id, i_manufact,
        sum(ss_ext_sales_price) as ext_price
        from date_dim, store_sales, item, customer, customer_address, store
        where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
        and i_manager_id = 8 and d_moy = 11 and d_year = 1998
        and ss_customer_sk = c_customer_sk
        and c_current_addr_sk = ca_address_sk
        and substring(ca_zip, 1, 5) <> substring(s_zip, 1, 5)
        and ss_store_sk = s_store_sk
        group by i_brand_id, i_brand, i_manufact_id, i_manufact
        order by ext_price desc, i_brand, i_brand_id, i_manufact_id,
        i_manufact limit 100""",
    # manager-window star (official query42)
    "42": """select d_year, i_category_id, i_category,
        sum(ss_ext_sales_price) as s
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
        and i_manager_id = 1 and d_moy = 11 and d_year = 2000
        group by d_year, i_category_id, i_category
        order by s desc, d_year, i_category_id, i_category limit 100""",
    # CASE pivot on day names (official query43)
    "43": """select s_store_name, s_store_id,
        sum(case when (d_day_name = 'Sunday') then ss_sales_price
            else null end) as sun_sales,
        sum(case when (d_day_name = 'Monday') then ss_sales_price
            else null end) as mon_sales,
        sum(case when (d_day_name = 'Friday') then ss_sales_price
            else null end) as fri_sales,
        sum(case when (d_day_name = 'Saturday') then ss_sales_price
            else null end) as sat_sales
        from date_dim, store_sales, store
        where d_date_sk = ss_sold_date_sk and ss_store_sk = s_store_sk
        and s_gmt_offset = -5 and d_year = 2000
        group by s_store_name, s_store_id
        order by s_store_name, s_store_id limit 100""",
    # brand revenue by year (official query52)
    "52": """select d_year, i_brand_id, i_brand,
        sum(ss_ext_sales_price) as ext_price
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
        and i_manager_id = 1 and d_moy = 11 and d_year = 2000
        group by d_year, i_brand_id, i_brand
        order by d_year, ext_price desc, i_brand_id limit 100""",
    # avg(sum()) OVER — quarterly manufacturer sales (official query53)
    "53": """select * from
        (select i_manufact_id, sum(ss_sales_price) as sum_sales,
         avg(sum(ss_sales_price)) over (partition by i_manufact_id)
             as avg_quarterly_sales
         from item, store_sales, date_dim, store
         where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk
         and d_month_seq in (1200, 1201, 1202, 1203, 1204, 1205, 1206,
                             1207, 1208, 1209, 1210, 1211)
         and i_manufact_id in (5, 10, 15, 20, 25, 30, 35, 40)
         group by i_manufact_id, d_qoy) tmp1
        where case when avg_quarterly_sales > 0
              then abs(sum_sales - avg_quarterly_sales)
                   / avg_quarterly_sales else null end > 0.1
        order by avg_quarterly_sales, sum_sales, i_manufact_id limit 100""",
    # manager brand revenue (official query55)
    "55": """select i_brand_id, i_brand, sum(ss_ext_sales_price)
        as ext_price
        from date_dim, store_sales, item
        where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
        and i_manager_id = 28 and d_moy = 11 and d_year = 1999
        group by i_brand_id, i_brand
        order by ext_price desc, i_brand_id limit 100""",
    # derived-table self-join on per-store average revenue (official q65)
    "65": """select s_store_name, i_item_desc, sc.revenue,
        i_current_price, i_wholesale_cost, i_brand
        from store, item,
        (select ss_store_sk, avg(revenue) as ave from
          (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
           from store_sales, date_dim
           where ss_sold_date_sk = d_date_sk
           and d_month_seq between 1176 and 1187
           group by ss_store_sk, ss_item_sk) sa
         group by ss_store_sk) sb,
        (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
         from store_sales, date_dim
         where ss_sold_date_sk = d_date_sk
         and d_month_seq between 1176 and 1187
         group by ss_store_sk, ss_item_sk) sc
        where sb.ss_store_sk = sc.ss_store_sk
        and sc.revenue <= 0.1 * sb.ave
        and s_store_sk = sc.ss_store_sk and i_item_sk = sc.ss_item_sk
        order by s_store_name, i_item_desc, sc.revenue limit 100""",
    # bought-city vs home-city (official query68)
    "68": """select c_last_name, c_first_name, ca_city, bought_city,
        ss_ticket_number, extended_price, extended_tax, list_price
        from (select ss_ticket_number, ss_customer_sk,
              ca_city as bought_city,
              sum(ss_ext_sales_price) as extended_price,
              sum(ss_coupon_amt) as extended_tax,
              sum(ss_ext_list_price) as list_price
              from store_sales, date_dim, store, household_demographics,
                   customer_address
              where ss_sold_date_sk = d_date_sk
              and ss_store_sk = s_store_sk
              and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
              and d_dom between 1 and 2
              and (hd_dep_count = 4 or hd_vehicle_count = 3)
              and d_year in (1999, 2000, 2001)
              and s_city in ('Midway', 'Fairview')
              group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
                       ca_city) dn,
        customer, customer_address
        where ss_customer_sk = c_customer_sk
        and c_current_addr_sk = ca_address_sk
        and ca_city <> bought_city
        order by c_last_name, ss_ticket_number limit 100""",
    # frequent-ticket counting (official query73)
    "73": """select c_last_name, c_first_name, ss_ticket_number, cnt
        from (select ss_ticket_number, ss_customer_sk, count(*) as cnt
              from store_sales, date_dim, store, household_demographics
              where ss_sold_date_sk = d_date_sk
              and ss_store_sk = s_store_sk
              and ss_hdemo_sk = hd_demo_sk
              and d_dom between 1 and 2
              and (hd_buy_potential = '>10000'
                   or hd_buy_potential = 'Unknown')
              and hd_vehicle_count > 0
              and d_year in (1999, 2000, 2001)
              and s_county in ('Williamson County', 'Ziebach County')
              group by ss_ticket_number, ss_customer_sk) dj, customer
        where ss_customer_sk = c_customer_sk and cnt between 1 and 5
        order by cnt desc, c_last_name asc, c_first_name asc,
                 ss_ticket_number limit 100""",
    # per-ticket profit by store city (official query79)
    "79": """select c_last_name, c_first_name,
        s_city, profit, ss_ticket_number, amt
        from (select ss_ticket_number, ss_customer_sk, s_city,
              sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
              from store_sales, date_dim, store, household_demographics
              where ss_sold_date_sk = d_date_sk
              and ss_store_sk = s_store_sk
              and ss_hdemo_sk = hd_demo_sk
              and (hd_dep_count = 6 or hd_vehicle_count > 2)
              and d_dom between 1 and 2
              and d_year in (1999, 2000, 2001)
              and s_number_employees between 200 and 295
              group by ss_ticket_number, ss_customer_sk, s_city) ms,
        customer
        where ss_customer_sk = c_customer_sk
        order by c_last_name, c_first_name, s_city, profit,
                 ss_ticket_number limit 100""",
    # avg(sum()) OVER with category/class lens (official query89)
    "89": """select * from
        (select i_category, i_class, i_brand, s_store_name, d_moy,
         sum(ss_sales_price) as sum_sales,
         avg(sum(ss_sales_price)) over (partition by i_category, i_brand,
                                        s_store_name) as avg_monthly_sales
         from item, store_sales, date_dim, store
         where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
         and ss_store_sk = s_store_sk and d_year in (1999)
         and i_category in ('Books', 'Electronics', 'Sports')
         group by i_category, i_class, i_brand, s_store_name, d_moy) tmp1
        where case when (avg_monthly_sales > 0)
              then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
              else null end > 0.1
        order by sum_sales - avg_monthly_sales, s_store_name,
                 i_category, i_class, i_brand, d_moy limit 100""",
    # time-of-day count (official query96)
    "96": """select count(*) as c
        from store_sales, household_demographics, time_dim, store
        where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
        and ss_store_sk = s_store_sk and t_hour = 8 and t_minute >= 30
        and hd_dep_count = 7 and s_store_name = 'ese'""",
    # revenue ratio via sum(sum()) OVER (official query98)
    "98": """select i_item_id, i_item_desc, i_category, i_class,
        i_current_price, sum(ss_ext_sales_price) as itemrevenue,
        sum(ss_ext_sales_price) * 100 /
            sum(sum(ss_ext_sales_price)) over (partition by i_class)
            as revenueratio
        from store_sales, item, date_dim
        where ss_item_sk = i_item_sk
        and i_category in ('Sports', 'Books', 'Home')
        and ss_sold_date_sk = d_date_sk
        and d_month_seq between 1176 and 1179
        group by i_item_id, i_item_desc, i_category, i_class,
                 i_current_price
        order by i_category, i_class, i_item_id, i_item_desc,
                 revenueratio limit 100""",
}
