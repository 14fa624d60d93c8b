"""The stateless goldens the port replays: each listed
``tests/goldens/stateless`` case runs through
``myscaledb_tpu_torch.testing.run_golden_text`` on a CPU session and must
come out byte-identical to its ``.reference``, the files the JAX package
passes in tests/test_goldens.py.  Every stateless case is listed.  ``00688_case_without_else``
holds the NULL branch of CASE without ELSE; ``02015`` and ``02017`` hold
WITH FILL, ``02513`` a window function, and the cases reading
``system.numbers`` or ``system.one`` (``00027``, ``00136``, ``00269``, ...)
those two tables; since the scalar-function slice, Date/DateTime literals
(``00479``, ``01718``), casts and hashes (``00653``, ``01085``), string
functions (``00727``, ``02150``) and ``uniq``/``quantileTDigest``
(``00188``); since the arrays-and-subqueries slice, ``arrayJoin()`` and
ARRAY JOIN (``00008``, ``00207``, ``01305``), lambdas (``00156``,
``00277``), array functions (``00036``, ``01659``), IN/scalar/EXISTS
subqueries (``00673``, ``02477_exists``), UNION/INTERSECT (``00592``,
``02316_const``), CTEs (``01495``, ``02212``) and JOIN on a subquery
(``00099``, ``02691``); since the storage slice, PARTITION BY (``00679``,
``01906``, ``02232``, ...) and skip indexes (``00974``, ``00979``,
``01771``, ...); since the breadth slice, views (``00472``),
materialized views (``00982``), ADD/DROP COLUMN (``00121``), MODIFY
SETTING (``01712``) and the Join engine (``00950``): 184 of the 184
stateless goldens."""

import os

import pytest
import torch

from myscaledb_tpu_torch import connect
from myscaledb_tpu_torch.testing import run_golden_text

torch.set_num_threads(1)

STATELESS = os.path.join(os.path.dirname(__file__), "goldens", "stateless")
CASES = [
    "00001_select_1", "00007_array", "00008_array_join",
    "00009_array_join_subquery", "00010_big_array_join",
    "00011_array_join_alias", "00012_array_join_alias_2",
    "00018_distinct_in_subquery", "00023_agg_select_agg_subquery",
    "00024_unused_array_join_in_subquery",
    "00025_implicitly_used_subquery_column", "00027_distinct_and_order_by",
    "00035_function_array_return_type", "00036_array_element",
    "00041_aggregation_remap", "00044_sorting_by_string_descending",
    "00064_negate_bug", "00068_empty_tiny_log",
    "00073_merge_sorting_empty_array_joined",
    "00099_join_many_blocks_segfault", "00114_float_type_result_of_division",
    "00121_drop_column_zookeeper",
    "00122_join_with_subquery_with_subquery", "00136_duplicate_order_by_elems",
    "00138_table_aliases", "00156_array_map_to_constant",
    "00157_aliases_and_lambda_formal_parameters",
    "00159_whitespace_in_columns_list", "00169_join_constant_keys",
    "00188_constants_as_arguments_of_aggregate_functions", "00202_cross_join",
    "00204_extract_url_parameter", "00207_left_array_join",
    "00234_disjunctive_equality_chains_optimization",
    "00238_removal_of_temporary_columns", "00266_read_overflow_mode",
    "00269_database_table_whitespace", "00277_array_filter",
    "00292_parser_tuple_element", "00333_parser_number_bug",
    "00338_replicate_array_of_strings", "00345_index_accurate_comparison",
    "00356_analyze_aggregations_and_union_all", "00369_int_div_of_float",
    "00464_sort_all_constant_columns", "00470_identifiers_in_double_quotes",
    "00472_create_view_if_not_exists",
    "00479_date_and_datetime_to_number", "00516_modulo",
    "00543_null_and_prewhere", "00553_invalid_nested_name",
    "00575_merge_and_index_with_function_in_in",
    "00582_not_aliasing_functions", "00592_union_all_different_aliases",
    "00607_index_in_in", "00647_select_numbers_with_offset",
    "00648_replacing_empty_set_from_prewhere",
    "00649_quantile_tdigest_negative", "00653_monotonic_integer_cast",
    "00673_subquery_prepared_set_performance", "00679_uuid_in_key",
    "00688_case_without_else", "00702_where_with_quailified_names",
    "00712_prewhere_with_final", "00717_default_join_type", "00727_concat",
    "00735_or_expr_optimize_bug", "00745_compile_scalar_subquery",
    "00749_inner_join_of_unnamed_subqueries", "00756_power_alias",
    "00800_low_cardinality_distributed_insert", "00818_join_bug_4271",
    "00836_numbers_table_function_zero", "00844_join_lightee2",
    "00856_no_column_issue_4242", "00874_issue_3495",
    "00906_low_cardinality_cache", "00914_join_bgranvea",
    "00931_low_cardinality_set_index_in_key_condition", "00933_reserved_word",
    "00950_bad_alloc_when_truncate_join_storage",
    "00957_delta_diff_bug", "00963_startsWith_force_primary_key",
    "00964_os_thread_priority", "00967_ubsan_bit_test",
    "00974_adaptive_granularity_secondary_index", "00979_set_index_not",
    "00982_low_cardinality_setting_in_mv",
    "01000_bad_size_of_marks_skip_idx", "01009_insert_select_data_loss",
    "01013_hex_float", "01016_null_part_minmax",
    "01018_optimize_read_in_order_with_in_subquery",
    "01020_having_without_group_by", "01030_final_mark_empty_primary_key",
    "01051_same_name_alias_with_joins", "01063_create_column_set",
    "01072_select_constant_limit", "01083_cross_to_inner_with_in_bug",
    "01085_simdjson_uint64", "01102_distributed_local_in_bug",
    "01117_greatest_least_case", "01126_month_partitioning_consistent_code",
    "01127_month_partitioning_consistency_select", "01234_to_string_monotonic",
    "01248_least_greatest_mixed_const", "01268_mergine_sorted_limit",
    "01280_opencl_bitonic_order_by", "01281_join_with_prewhere_fix",
    "01305_array_join_prewhere_in_subquery",
    "01307_bloom_filter_index_string_multi_granulas", "01319_mv_constants_bug",
    "01322_monotonous_order_by_with_different_variables",
    "01328_bad_peephole_optimization", "01349_mutation_datetime_key",
    "01362_year_of_ISO8601_week_modificators_for_formatDateTime",
    "01375_null_issue_3767", "01379_with_fill_several_columns",
    "01416_join_totals_header_bug",
    "01427_pk_and_expression_with_different_type",
    "01431_finish_sorting_with_consts", "01457_compile_expressions_fuzzer",
    "01457_order_by_limit", "01495_subqueries_in_with_statement_2",
    "01496_signedness_conversion_monotonicity",
    "01503_fixed_string_primary_key",
    "01507_multiversion_storage_for_storagememory",
    "01561_aggregate_functions_of_key_with_join",
    "01600_min_max_compress_block_size", "01656_test_hex_mysql_dialect",
    "01659_array_aggregation_ubsan", "01670_test_repeat_mysql_dialect",
    "01704_transform_with_float_key",
    "01712_no_adaptive_granularity_vertical_merge",
    "01718_subtract_seconds_date",
    "01747_transform_empty_arrays", "01771_bloom_filter_not_has",
    "01820_unhex_case_insensitive", "01881_to_week_monotonic_fix",
    "01891_not_like_partition_prune", "01906_partition_by_multiply_by_zero",
    "01907_multiple_aliases", "01908_with_unknown_column",
    "01913_join_push_down_bug", "01938_joins_identifiers",
    "02015_order_by_with_fill_misoptimization",
    "02017_order_by_with_fill_redundant_functions",
    "02023_nullable_int_uint_where", "02096_join_unusual_identifier_begin",
    "02100_limit_push_down_bug", "02112_skip_index_set_and_or",
    "02131_remove_columns_in_subquery", "02150_replace_regexp_all_empty_match",
    "02151_lc_prefetch", "02179_key_condition_no_common_type",
    "02189_join_type_conversion", "02212_cte_and_table_alias",
    "02232_partition_pruner_single_point", "02247_fix_extract_parser",
    "02304_grouping_set_order_by", "02316_const_string_intersact",
    "02316_literal_no_octal", "02420_key_condition_actions_dag_bug_40599",
    "02428_delete_with_settings", "02428_partial_sort_optimization_bug",
    "02459_read_in_order_bufer", "02462_match_regexp_pk",
    "02477_analyzer_ast_key_condition_crash", "02477_exists_fuzz_43478",
    "02479_nullable_primary_key_second_column",
    "02482_if_with_nothing_argument", "02502_analyzer_insert_select_crash_fix",
    "02510_group_by_prewhere_null", "02513_analyzer_sort_msan",
    "02521_cannot_find_column_in_projection", "02535_analyzer_limit_offset",
    "02541_multiple_ignore_with_nested_select",
    "02577_analyzer_array_join_calc_twice", "02584_range_ipv4",
    "02675_replicated_merge_tree_insert_zookeeper_long",
    "02677_grace_hash_limit_race", "02680_lc_null_as_default",
    "02691_multiple_joins_backtick_identifiers",
    "02692_multiple_joins_unicode",
]


@pytest.mark.parametrize("name", CASES)
def test_stateless_golden(name):
    sql_text = open(os.path.join(STATELESS, name + ".sql")).read()
    expected = open(os.path.join(STATELESS, name + ".reference")
                    ).read().rstrip("\n").split("\n")
    if expected == [""]:
        expected = []
    got = run_golden_text(connect(device="cpu"), sql_text)
    assert got == expected
