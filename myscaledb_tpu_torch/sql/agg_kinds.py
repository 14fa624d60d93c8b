"""Copy of myscaledb_tpu/sql/agg_kinds.py (JAX-free; imports renamed to this package).

Aggregate-function name registries shared by the SELECT orchestrator
(sql/executor.py) and the per-kind evaluators (sql/agg_fns.py) — the
AggregateFunctionFactory name table analog
(src/AggregateFunctions/AggregateFunctionFactory.h)."""

AGG_NAMES = {"count", "sum", "min", "max", "avg", "any", "uniqexact",
             "argmin", "argmax", "countif", "sumif", "minif", "maxif",
             "avgif", "quantile", "median",
             "varpop", "varsamp", "stddevpop", "stddevsamp",
             "covarpop", "covarsamp", "corr", "anylast",
             "uniq", "uniqcombined", "uniqhll12", "uniqtheta",
             "sumdistinct", "avgdistinct", "countdistinct",
             "groupbitand", "groupbitor", "groupbitxor",
             "quantileexact", "quantileexactlow",
             "grouparray", "groupuniqarray", "quantiles", "topk",
             "quantiletdigest",
             # -State / -Merge combinator spellings
             "sumstate", "summerge", "countstate", "countmerge",
             "minstate", "minmerge", "maxstate", "maxmerge",
             "avgstate", "avgmerge", "uniqstate", "uniqmerge",
             "quantiletdigeststate", "quantiletdigestmerge"}
SPECIAL_AGGS = {"uniqexact", "argmin", "argmax", "quantile", "median",
                "varpop", "varsamp", "stddevpop", "stddevsamp",
                "covarpop", "covarsamp", "corr", "anylast",
                "uniq", "uniqcombined", "uniqhll12", "uniqtheta",
                "sumdistinct", "avgdistinct", "countdistinct",
                "groupbitand", "groupbitor", "groupbitxor",
                "quantileexact", "quantileexactlow",
                "grouparray", "groupuniqarray", "quantiles", "topk",
                "quantiletdigest"}
# exact-distinct implementations; the reference's uniq/uniqCombined/uniqHLL12
# are approximate sketches (src/AggregateFunctions/AggregateFunctionUniq.h) —
# exact counts are a strict-precision superset of that contract.
UNIQ_KINDS = {"uniq", "uniqexact", "uniqcombined", "uniqhll12", "uniqtheta",
              "countdistinct"}
VAR_KINDS = {"varpop", "varsamp", "stddevpop", "stddevsamp"}
COVAR_KINDS = {"covarpop", "covarsamp", "corr"}
BIT_KINDS = {"groupbitand", "groupbitor", "groupbitxor"}
IF_COMBINATORS = {"countif": "count", "sumif": "sum", "minif": "min",
                  "maxif": "max", "avgif": "avg"}
