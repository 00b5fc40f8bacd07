"""The cache-key INPUT schema of the port: every environment input the
PyTorch package reads, declared once (copy of the registry in
processing_chain_tpu/store/plan_schema.py, trimmed to the reads this
package makes).

Plan-hash identity is the load-bearing wall of the system: the
content-addressed store serves bytes by plan hash and chain-serve dedupes
across tenants by it, so an input that influences artifact bytes but
escapes the plan is a silent cache-poisoning bug — the same plan hash
would name two different byte streams.

Entry statuses, as in the JAX package's registry:

  * ``plan``    — the input changes artifact bytes; its (effective) value
    is folded into the plan payload under ``plan_key``.
  * ``exempt``  — the input provably never alters encoded bytes (thread
    counts, chunk granularity, process topology). Every read site carries
    a ``# plan-exempt: (reason)`` annotation on the line above, and the claim stays under the runtime recorder's
    same-plan/different-bytes gate (utils/plandebug.py, checked by
    tests/test_torch_plandebug.py).

The knob names are the JAX package's: both packages read the same
environment. ``tools chain-lint``'s ``plan-purity`` rule reads only the
JAX package's registry, which declares every ``PC_*`` knob below; the
torch topology variables are this package's counterparts of its
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``. Keep every entry a literal.
tests/test_torch_plandebug.py holds the entries equal to the ``PC_*`` and
topology reads the package makes, each ``exempt`` read annotated and each
``plan_key`` in the wo_buffer plan.
"""

from __future__ import annotations

#: env input -> {"status": "plan"|"exempt", "reason": …[, "plan_key": …]}
ENV_INPUTS: dict[str, dict] = {
    # ---------------------------------------------------- byte-affecting
    "PC_AVPVS_CODEC": {
        "status": "plan",
        "plan_key": "codec",
        "reason": "selects the AVPVS intermediate codec (ffv1 vs "
                  "rawvideo): different container bytes by definition; "
                  "models/avpvs records the EFFECTIVE codec in every "
                  "avpvs plan",
    },
    "PC_FFV1_SLICES": {
        "status": "plan",
        "plan_key": "ffv1_slices",
        "reason": "slices change FFV1 bitstream structure, hence bytes; "
                  "the effective slice count is recorded in the avpvs "
                  "plan payloads (ffv1_effective_slices)",
    },
    "PC_RESIZE_METHOD": {
        "status": "plan",
        "plan_key": "resize",
        "reason": "the port's render has no resize switch; its float "
                  "route is banded on the card and gather on the CPU, "
                  "which differ by up to one code value per pixel, so "
                  "plans record the method identity "
                  "(ops/resize.plan_resize_method: 'torch-auto:<device "
                  "type>', never a value the JAX package records). The "
                  "read only refuses any value other than 'auto'",
    },
    # ------------------------------------------------ never alters bytes
    "PC_FFV1_THREADS": {
        "status": "exempt",
        "reason": "slice-threading width parallelizes the encode of the "
                  "slice layout the plan already records (ffv1_slices "
                  "captures its effect on the default slice count); the "
                  "thread count itself does not alter encoded bytes",
    },
    "PC_FFV1_WORKERS": {
        "status": "exempt",
        "reason": "frame-parallel worker count schedules whole-frame "
                  "encodes across private contexts; the slices=0 regime "
                  "it selects is captured by the recorded ffv1_slices, "
                  "and worker count itself does not alter encoded bytes",
    },
    "PC_CHUNK_FRAMES": {
        "status": "exempt",
        "reason": "frames-per-device-batch granularity; the emitted "
                  "frame stream is identical at any chunking (pinned by "
                  "the batch-vs-single parity tests)",
    },
    "PC_DECODE_WORKERS": {
        "status": "exempt",
        "reason": "segment-decode prefetch width; MultiSegmentPrefetcher "
                  "preserves segment order, so the decoded stream is "
                  "identical at any width",
    },
    "PC_SCAN_PRIME": {
        "status": "exempt",
        "reason": "p01's post-encode shared-scan priming fills a cache of the "
                  "finished segment's packet tables; the encoded bytes are "
                  "written before it runs",
    },
    "PC_STORE_DIR": {
        "status": "exempt",
        "reason": "names WHERE the store lives, never what any artifact "
                  "contains",
    },
    "PC_STORE_TIERS": {
        "status": "exempt",
        "reason": "names WHERE artifact bytes are placed across store "
                  "tiers (and the budgets moving them), never what any "
                  "artifact contains",
    },
    "PC_RUN_ID": {
        "status": "exempt",
        "reason": "multi-process barrier namespace (parallel/distributed "
                  "rendezvous); no artifact byte depends on it",
    },
    "WORLD_SIZE": {
        "status": "exempt",
        "reason": "process topology (JAX_NUM_PROCESSES in the JAX "
                  "package) shards WHICH process renders each lane; "
                  "per-artifact bytes are topology-invariant",
    },
    "RANK": {
        "status": "exempt",
        "reason": "process topology (JAX_PROCESS_ID in the JAX package) "
                  "shards WHICH process renders each lane; per-artifact "
                  "bytes are topology-invariant",
    },
    "PC_LIBAV_DIRS": {
        "status": "exempt",
        "reason": "names the folder io/medialib binds libav from; the "
                  "copy bound must pass the struct layout check, and "
                  "decoded frames are held identical across libavs (FFV1 "
                  "bytes may differ between libav versions, a difference "
                  "the plan does not key, as the JAX package's does not)",
    },
    "PC_FUSE_P04": {
        "status": "exempt",
        "reason": "routing only: the fused p03+p04 fan-out (models/fused) "
                  "renders the stalling pass and every CPVS from the "
                  "quantized frames a decode of the lossless AVPVS would "
                  "return, through the same transforms, compositor and "
                  "writers as the staged route, and commits each member "
                  "under the staged job's plan hash; decoded-identical "
                  "(tests/test_torch_fused_file.py)",
    },
    "PC_PROFILE_DEVICE": {
        "status": "exempt",
        "reason": "observability only: forces the profile's torch.profiler "
                  "device capture on or off (telemetry/profiling); no "
                  "artifact byte depends on the read",
    },
    "LOCAL_RANK": {
        "status": "exempt",
        "reason": "picks the card a process joins NCCL on; the kernels "
                  "produce the same bytes on every card",
    },
}
