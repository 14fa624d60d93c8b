"""Copy of myscaledb_tpu/config.py (JAX-free; imports renamed to this package).

Three-tier settings, mirroring the reference's config scopes:

  cluster  (config.xml + ServerSettings)           -> ClusterConfig
  session  (742-entry Settings macro table,
            src/Core/Settings.h:38)                -> Settings
  table    (MergeTreeSettings.h incl. vector knobs) -> TableSettings

Names are kept where the semantics carried over (max_block_size,
max_threads -> chips, hybrid_search_* fusion knobs per Settings.h:919-921).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass
class ClusterConfig:
    """Static mesh description (the reference's Cluster, src/Interpreters/Cluster.h)."""
    mesh_axis_name: str = "shard"
    num_shards: int = 1            # devices along the table-partition axis


@dataclass
class Settings:
    """Per-session / per-query settings."""
    max_block_size: int = 65536          # rows per streamed block (ref: 65409)
    vector_scan_block_rows: int = 32768  # X-tile rows in the distance scan
    vector_stage1_precision: str = "high"   # selection matmul: default|high|highest
    vector_rescore_margin: int = 16
    max_threads: int = 0                 # 0 = all local devices
    # vector search (reference: src/Core/Settings.h:918-921)
    enable_brute_force_vector_search: bool = True
    hybrid_search_fusion_weight: float = 0.5
    hybrid_search_fusion_k: int = 60
    hybrid_search_top_k_multiple_base: int = 3
    # execution
    use_pallas_kernels: bool = True      # pallas fast paths where available
    group_by_capacity_hint: int = 1 << 16
    # memory governance (reference: MemoryTracker hierarchy,
    # src/Common/MemoryTracker.h:50 — triggers spills instead of OOM)
    max_memory_bytes_per_query: int = 512 * 1024 * 1024  # score-matrix budget
    # uniqCombined: exact distinct set below this row count, HLL(2^12)
    # sketch above (reference uniqCombined.h small-set optimization)
    uniq_combined_exact_rows: int = 1 << 17
    max_hbm_bytes_per_column: int = 0    # >0: bigger columns stay host-side
    stream_chunk_rows: int = 8 << 20     # rows per chip chunk when streaming
                                         # host-resident columns (GROUP BY /
                                         # top-n spill tier)
                                         # and stream through HBM block-wise
    # join (reference: Settings.h join_algorithm, grace_hash_join_*;
    # GraceHashJoin.cpp) — "auto" switches to partitioned grace join when the
    # build side exceeds max_rows_in_hash_join_build
    join_algorithm: str = "auto"         # hash | grace_hash | auto
    grace_hash_join_initial_buckets: int = 8
    max_rows_in_hash_join_build: int = 32 * 1024 * 1024
    # distributed execution strategy knobs (reference: GLOBAL JOIN broadcast
    # src/Interpreters/GlobalSubqueriesVisitor.h; shuffle-repartition P6 and
    # distributed_aggregation_memory_efficient in Settings.h)
    distributed_broadcast_join_threshold: int = 1 << 21   # build rows
    distributed_group_by_shuffle_threshold: int = 1 << 14 # groups
    # LIMIT pushdown of top-k into the distance scan (ref: TreeRewriter.cpp:1671)
    max_search_top_k: int = 1 << 20
    # result cache (reference: src/Interpreters/Cache/QueryCache.h)
    use_query_cache: bool = False
    query_cache_max_entries: int = 128
    # quotas / limits (reference: SizeLimits.h, ExecutionSpeedLimits.h)
    max_result_rows: int = 0          # 0 = unlimited
    max_execution_time: float = 0.0   # seconds; checked post-execution
    readonly: int = 0                 # 1 = reject DDL/DML (reference semantics)
    # filesystem confinement for file()/File-engine/INFILE paths (reference:
    # StorageFile::checkCreationIsAllowed + user_files_path in config.xml).
    # Empty = unconfined (embedded/library use); servers set it at startup.
    user_files_path: str = ""

    # Template / Regexp / CustomSeparated format knobs (reference:
    # src/Formats/FormatSettings.h template_settings/regexp_settings/
    # custom_settings; *_format variants take the template inline)
    format_template_resultset: str = ""      # file path with ${data}
    format_template_row: str = ""            # file path with ${col:Esc}
    format_template_row_format: str = ""     # inline row template
    format_template_resultset_format: str = ""
    format_template_rows_between_delimiter: str = "\n"
    format_regexp: str = ""
    format_regexp_escaping_rule: str = "Raw"
    format_regexp_skip_unmatched: bool = False
    format_custom_escaping_rule: str = "Escaped"
    format_custom_field_delimiter: str = "\t"
    format_custom_row_before_delimiter: str = ""
    format_custom_row_after_delimiter: str = "\n"
    format_custom_row_between_delimiter: str = ""
    format_custom_result_before_delimiter: str = ""
    format_custom_result_after_delimiter: str = ""

    def copy(self, **kw) -> "Settings":
        return replace(self, **kw)


@dataclass
class TableSettings:
    """Per-table settings (reference: MergeTreeSettings.h)."""
    float_vector_search_metric_type: str = "L2"    # ref :183
    binary_vector_search_metric_type: str = "Hamming"   # ref :184 (HAMMING)
    partition_block_rows: int = 65536
