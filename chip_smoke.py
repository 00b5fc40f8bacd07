#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (processing_chain_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # every phase, then the result lines
    python3 chip_smoke.py --phases 16,18    # phases 1-2, then these alone
    python3 chip_smoke.py --steadiness 8 [--against DIR]
                                            # phase 16's wall-clock gates, repeated

Phases, each fatal on failure: the run stops there and prints one line,
`chip_smoke: FAILED in phase <n> (<name>): <message>`, exits 1 and prints
no result line. Each phase's start is logged with its number and name,
its end with its seconds:
  1. device: CUDA must be present; prints the card's name and power limit,
     the libav that io/medialib located, built csrc/media.cpp against and
     checked (fatal when none binds), and, for information only, whether
     yaml, pandas, PIL and matplotlib import
  2. build: compiles csrc/*.cu with nvcc (one process per source, all at
     once) and prints each kernel's registers, shared memory and spills
  3. kernel vs plain torch version at the main paths' shapes (the fused
     SI+TI kernels also against the separate SI and TI kernels; the resize
     also at the downstream render's geometries and at p01's quality
     ladder from 2160p, each on the route its plan names)
  4. the p03 device seam: a seeded synthetic 600-frame 1920x1080 yuv420p
     clip through models.avpvs.pump_ready onto a 3840x2160 canvas in
     64-frame chunks, then a 128-frame yuv420p10le clip; launch counts,
     sidecar rows and the first chunk against the plain path are checked;
     frames/s end to end
  5. the flagship step: parallel.pipeline.avpvs_siti_step on seeded u8
     [64, 1080, 1920] planes -> 2160x3840 lanczos, without and with
     prev_last; launch counts, planes and SI/TI against the plain versions;
     device ms per call
  6. the wave render: parallel.p03_batch.run_bucket, 1920x1080 yuv420p ->
     3840x2160 bicubic, chunk 64, on (a) the production mesh make_mesh()
     (pvs=1) with lanes of 600 and 250 frames and (b) a 4-lane mesh on the
     card with lanes of 200, 130, 100, 64 and 40 frames; launch counts,
     the wave journal's slot accounting, each lane's frame count, first
     block (against the plain resize) and SI/TI (against the lane rendered
     alone through pump_ready) are checked; frames/s end to end
  7. the downstream render: phase 4's 600-frame clip through pump_ready
     onto the 3840x2160 60 fps canvas, its quantized chunks left on the
     card and fed to the fused fan-out (models/fused.FanoutStream): two
     spinner stalls (600 -> 690 frames, a seeded synthetic RGBA spinner)
     composited into a stalled-AVPVS sink, a PC context (UYVY 3840x2160
     at 30 fps, 345 frames), a mobile context (bicubic to 1920x1080) and
     the preview (422 10-bit); then the staged route (plan_stalling + the
     monotonic gather + the same compositor) over the same frames, whose
     checksum and frame count must equal the fused route's; the first
     stall chunk and each context's first chunk against the port's plain
     path on the CPU; resize launches against each pipeline's chunk
     count. Then phase 4's 128-frame yuv420p10le clip with a frame freeze
     (128 frames kept) into a PC v210 and a mobile context. Frames/s of
     each route, device ms per 64-frame chunk of the composite and of
     each transform, peak device bytes
  8. timing of each kernel at the main paths' shapes beside its bound, its
     plain version and, where one exists, a PyTorch library call (for the
     resize also the antialiased call, as information); the resize also at
     the mobile CPVS downscale and at the 640x360 and 320x180 ladder levels
     of a 2160p chunk
  9. p01's quality ladder (models.segments.scaled_chunks: host chunk ->
     fps select -> host-to-device copy -> bicubic scale -> device-to-host
     copy through pinned memory, the smoke's checksum standing in for the
     encoder): (a) a seeded 240-frame 2160p60 yuv420p segment to
     1920x1080@30, 1280x720@30, 640x360@24 and 320x180@15, (b) the first
     240 frames of phase 4's 1080p clip to 1280x720@30 (1.5x, resize_ring)
     and 640x360@24, (c) a 128-frame 2160p60 yuv420p10le segment to
     1920x1080@30 at 10 bits; frames kept, resize launches (3 a non-empty
     chunk) and each plane's route, the first chunk against the plain
     resize on the card and its first frames against the CPU route; source
     frames/s end to end and device ms per chunk
 10. the quality tools: tools.quality_metrics.score_chunks on phase 4's
     600-frame AVPVS (pump_ready's quantized 3840x2160 chunks, kept on the
     card) against its 1080p SRC in 32-frame chunks, MS-SSIM and VIF on
     (the SRC goes up by the banded f32 route), then the 128-frame 10-bit
     clip; SI/TI against pump_ready's accumulator, the first frames against
     the CPU route (banded forced), an identity pair; frames/s, device ms
     per chunk of the SRC resize and of each metric, peak device bytes.
     Then tools.src_analysis.src_siti_summary over phase 9's 2160p
     segments and priors.features.temporal_features on a seeded 240-frame
     1080p MV table, each against the CPU route
 11. the serve path: processing_chain_tpu_torch.serve.ChainServeService
     with the `wave` executor on the card (workers 1, wave width 4), over
     HTTP: request A (lab-a, P2STR01, SRC001-002 x HRC001-002: 4 units of
     60 seeded 1920x1080 yuv420p frames -> 3840x2160 bicubic), request B
     (lab-b, SRC002 x HRC002-003) posted while A runs (one unit shared),
     both done, then A again (warm). Every request done, 5 plans executed
     once each, no new wave for the warm re-POST, every artifact fetched
     over /v1/artifacts equal (sha256) to its unit's seeded YUV through
     the plain resize on the card, the wave journal's valid + pads ==
     dispatched on every record; cold seconds of A and B, warm ms, served
     frames/s, batches and lanes, launches, device ms per 8-frame wave
     block, peak device bytes, bytes written; the serve root is removed
 12. the (pvs, time) mesh: (a) run_bucket on make_mesh([cuda:0] * 4,
     time_parallel=2) (pvs=2, time=2, the one-frame TI halo between the
     64-frame block's two 32-frame halves) with lanes of 600, 250, 200 and
     130 frames, 1920x1080 yuv420p -> 3840x2160 bicubic: every emitted
     block equal to the plain resize on the card, SI/TI within 1e-3 of
     the plain route chained across chunks and of the same lanes on the
     pvs-only 4-slot mesh (4x1), the journal's valid + pads ==
     dispatched and mesh "2x2" on every record, 3 resize + 1
     siti_frames_fused_batch launches a block; then both meshes unchecked
     for frames/s, and the wave step's device ms a resident block;
     (b) parallel.pipeline.make_sharded_step on seeded u8 [2, 64, 1080,
     1920] -> 2160x3840 lanczos over the 2x2 mesh against avpvs_siti_step
     per lane with prev_last chained across the time halves; (c) the stall
     compositor sharded over the 4 slots on phase 7's first stalled chunk
     (spinner) and a freeze chunk, identical to one device, and
     make_batch_metrics_step on the mesh equal to one slot; (d) with two
     or more cards, (a) again on distinct cards, else one line saying that
     route was not run
 13. the profiling plane on the card: (a) one window under
     telemetry.profiling.Profiler with the torch.profiler device trace,
     in a stage_span: a 128-frame u8 pump_ready seam (kernels 1-3), wave
     (a)'s lanes of 600 and 250 through run_bucket on make_mesh()
     (kernels 1 and 4) and one instrumented flagship avpvs_siti_step
     call (kernel 5); the profile's three artifacts must be written, the
     device trace must hold each kernel family's launches of the window
     (symbols read from the trace, mapped by ops.cuda_kernels.
     launch_names), the merged host trace the device:<step>,
     transfer:device_put/get and wave spans, attribute_run a verdict with
     transfer and compute measured, and the chain_device_memory_bytes
     gauges must equal torch.cuda.memory_stats of the same sample;
     (b) the kernel and copy busy shares of the seam's and the wave's
     windows, read from the trace, beside the estimates phases 4, 6 and 8
     give (kernel ms x launches / host window); wave (a)'s frames/s
     unprofiled with telemetry off and on in turns (the wave loop's
     instrumentation), and profiled beside the last unprofiled run just
     before the window (the capture); (c) `tools run-report` and `tools
     chain-profile` over the window's directory, as processes; (d) on
     phase 11's service before it stops: GET /status's resources
     (cuda:0's memory), counters and serve.stalls, a watchdog with a
     0.5 s soft limit flagging a held heartbeat within 2 s (in
     active_stalls and in /status) and clearing it on a beat, and the
     status-file writer of `--status-file` rewriting its file
 14. the database: a short-test database YAML (P2STR14: SRC000 3840x2160
     yuv420p 60 fps and SRC001 1920x1080 yuv420p10le 30 fps, 10 s each;
     a ladder 640x360@30 .. 3840x2160; five HRCs with a mid-PVS stall, a
     freeze and an initial stall; pc 3840x2160, tablet 2560x1440 and
     mobile 1920x1080 post-processings; 8 PVSes) written into
     build/chip_smoke/ with empty SRC files, loaded through the port's
     config.TestConfig with a StaticProber. For each PVS, from its domain
     objects: each segment of its first 4.5 s of media (the cut; full
     width) through p01's device half (plan_segment_frames(segment),
     scaled_chunks) from a seeded synthetic source at the SRC's
     geometry; the p01 frames on the canvas time grid through pump_ready
     to avpvs_dimensions(pvs) at canvas_fps(pvs); with buffering,
     plan_stalling over get_buff_events_media_time() and pump_stalled;
     cpvs_plan(pvs, pp, h) for each post-processing through its context
     pipeline; _wo_buffer_plan and cpvs_plan hashed with plan_hash. Frame
     counts against the plans, each stage's launches, each stage's first
     chunk against the plain path on the card (the CPVS transforms with
     the resize kernel's wrapper swapped for resize_frames_plain; the
     stall pass also over the chunk holding its first stalled frame and
     the 64 frames from it) and its first frame (the stall pass: its
     first stalled frame) against the CPU route (u8 planes bit-exact, u16
     within a code value, SI/TI within 1e-3 / 1e-2, composite and CPVS
     frames equal);
     one line a PVS: canvas, frames, frames/s, device ms a chunk, plan
     hashes; its launches join `paths` as db_<pvs_id>
 15. the serve control plane, under build/chip_smoke/control (removed
     after): (a) `tools fleet-doctor --soak` as a process (synthetic
     executor) on a RAM-backed root (see below), held to ALERTS_r20.json's invariants (ok, no failure, a
     silent control phase, slo_burn_queue_wait + store_eviction_regret +
     fleet_replica_stale fired and nothing outside the soak's tolerated
     set, every episode resolved, the scale signal up under the breach
     and steady after); (b) two `wave` replicas of ChainServeService on
     the card over one root (poll 0.1 s, control ticks 0.15 s, alert
     windows x0.001, a store budget of 6 artifacts, admission and wave
     budgets from serve.cost.predict_unit_cost, cost calibration on),
     8-frame 1920x1080 -> 3840x2160 units: 1. 4 units to each replica,
     two shared (6 executions, every artifact over HTTP equal to the
     plain resize, waves packed by predicted seconds, no alert); 2. one
     plan pinned by `tools store-admin pin`, then a seventh unit: the
     service's completion hook evicts LRU down to the budget and keeps
     the pinned plan; 3. an evicted plan POSTed again: recomputed, same
     bytes, `tools store-heat report` counts the regret; 4. an 8-unit
     POST refused with the 429 body, the queue untouched; 5. replica A
     stopped with a request outstanding, B's tick adopts and finishes
     it; 6. /fleet, /fleet/scale-signal and /fleet/alerts (against
     alerts.fold of the journals) on B; 7. one observed/predicted ratio
     for each of the 10 executions, then B settles units until its
     maintenance tick refits the calibration scale (--cost-calibrate);
     exact launch counts, which join `paths` as serve_control; frames/s
     of each step, the ratio percentiles and the fitted scale, the
     evicted bytes and the alert set
 16. the serve fleet's proof harnesses, on a RAM-backed root (see
     below), at the tools' defaults (the reference's): (a) `tools
     serve-soak --executor wave --device cuda:0` in this process (8
     clients, 6 SRCs x 4 HRCs, overlap 0.5, the wave executor's 8-frame
     36x64 -> 72x128 units): rc 0 (zero duplicate executions, every
     request done, the warm pass under its budget), 3 resize and 1
     siti_frames_fused_batch launches a block of the wave journal (which
     join `paths` as serve_soak), one served artifact equal to the same
     plan on the CPU route; cold wall, warm p50, the queue-wait,
     execution and e2e p50/p95/p99; (b) `tools serve-soak --pack-bench`
     as a process: rc 0 (cost-aware packing's predicted-seconds cv below count
     packing's, its e2e p95 below too); (c) `tools serve-chaos
     --corrupt-corpus` (3 port replicas of `chain-serve --executor
     synthetic`, 2 SIGKILLs, 1 SIGSTOP past the lease) and `tools
     serve-chaos --self-test`, as processes: both exit 0; lease steals,
     poisoned digests, warm p50 during churn, each replica's seconds to
     /healthz, wall time; (d) `tools trace show` as a process on one of
     (a)'s requests and on a done request of (c) with a stolen unit:
     "trace: COMPLETE" and a Chrome export with events
 17. the port's own gates: (a) `tools chain-lint` as a process, bare (the
     port's package and this script against the port's telemetry catalog,
     store/plan_schema.py, serve/queue.py and baseline): exit 0 and
     "chain-lint: OK", its files, findings and baselined counts and its
     seconds; (b) with PC_LOCK_DEBUG=1 and PC_PLAN_DEBUG=1 set before any
     object is built (and restored after), both port recorders reset,
     phase 11's `wave` service on the card under build/chip_smoke/gates
     (removed after) with one request of 2 units (SERVE_GEO), exact
     launches (which join `paths` as serve_gates), a warm re-POST, both
     artifacts against the plain route; then utils.lockdebug.check() (at
     least one edge, acyclic) and utils.plandebug.check() (2 plans, no
     same-plan/different-bytes): edges, locks, plans and seconds
 18. the media boundary and p03's file-level single-device route, on a
     RAM-backed root (see below; the stage CLIs' files go there, not over
     the checkout's 9p mount): (a) the libav io/medialib
     bound (paths, versions, the layout entries its round trips passed),
     which of h264, hevc, vp9, av1, aac and flac it decodes (h264
     required; an absent one is named), which of the rawvideo, v210
     and prores_ks encoders it has, which of p01's (libvpx-vp9, libx265,
     libaom-av1, libx264, libopus, aac), what the two-pass round trips at
     load found (libvpx-vp9, libaom-av1), whether the AVBSFContext layout
     entries passed and which of p02's bitstream filters it has, and each
     committed fixture
     (processing_chain_tpu_torch/assets/media) decoded through the port's
     VideoReader to the per-plane md5s the JAX reader recorded, its
     LibavProber width, height, pix_fmt, frame rate, frame count and
     duration (within 1 ms) equal to the record, other probe fields that
     differ from FFmpeg 5.1's printed; (b) P2STR18, a short-test database
     written with SRC000 (1920x1080 yuv420p 60 fps, 120 frames, FLAC
     stereo) and its segments as FFV1+FLAC through the port's VideoWriter
     (the card's libav has no H.264 encoder), loaded with the libav
     prober; `python -m processing_chain_tpu_torch p03` as a process on
     cuda:0 for HRC000 (one 2 s segment), HRC001 (a stall between two
     1 s segments) and HRC002 (two frame freezes, (d)): its summary's
     launches (3 resize + 1 SI + 1 TI a 64-frame chunk), decoder opens
     (one a rendered segment, two a stall pass) and buffer pool (hits,
     nothing outstanding); each wo_buffer AVPVS against
     resize_frames_plain of its decoded segment on the card (bit-exact)
     and its .siti.csv against si/ti_frames_plain (1e-3); the stalled
     AVPVS's frame count against its plan, the frames at each edge of its
     stall against the compositor on the CPU, its audio the segment's
     with the planned silence; frames/s, and each CLI process's seconds
     before its stage starts (its start-up line); (c) SRC001 (yuv420p10le, 32
     fps, 64 frames) through the CLI with `--avpvs-codec rawvideo`, which
     writes the FFV1 fallback, held the same way (planes within a code
     value, SI/TI within 1e-2), with the observability flags `--telemetry
     DIR --profile DIR --status-file F`: the artifact set under one stamp
     (metrics .json/.prom, the streamed events, the span trace, the
     profile's merged trace and resources, device_<stamp>/trace.json),
     the device trace's kernel events per family equal to the call's
     summary launches, the events' run records, the status file's final
     snapshot, and `tools run-report DIR` and `tools chain-profile DIR` as
     processes exiting 0; (d) HRC002, two frame freezes (0.25 s and
     0.5 s) after a 1 s segment, from (b)'s CLI run: its frozen AVPVS as
     long as the wo_buffer render, the frames at each freeze's edges
     equal to the compositor's plain route on the CPU over the skipping
     plan's gather, its audio untouched; (e) P2LTR18, the same SRC as a
     long test (two 1 s FFV1+FLAC segments, a 0.5 s stall at the join)
     through the CLI: launches from its segments' canvas chunks (3 resize
     + 1 SI + 1 TI a chunk, a segment never sharing one), the stage's
     decoder opens (one a segment), the 120-frame wo_buffer AVPVS against
     the plain route over its segments decoded in turn (bit-exact, SI/TI
     within 1e-3, TI chained across the join), its audio the SRC's over
     the PVS's 2 s, the 150-frame stalled AVPVS as in (b); (f) `python -m
     processing_chain_tpu_torch p04 -e` as one process on cuda:0 over
     (b)'s files: HRC001 (u8, stalled: PC rawvideo UYVY422 at 3840x2160)
     and (c)'s SRC001_HRC000 (10-bit: v210, 32 -> 60 fps), each with its
     ProRes preview (the rawvideo, v210 and prores_ks encoders, which (a)
     lists, required): the summary's resize launches (2 a chunk: the
     420->422 lift), decoder opens (one a render) and buffer pool; each
     CPVS's frame count against cpvs_plan and cpvs_out_rate, its decoded
     planes against make_cpvs_transform with resize_frames_plain over the
     decoded AVPVS on the card (bit-exact; v210 keeps codes 4..1019), its
     first frame and the frames at the stall's edges against the CPU
     route; HRC001's preview encoder input (the transform on the card)
     against the plain route and its decoded luma against it by PSNR, both
     previews' codec, geometry, pix_fmt and frame count from the prober;
     the AVPVS files and sidecars untouched; frames/s and the summary's
     decode, device and writeback seconds; (g) `PC_FUSE_P04=1 python -m
     processing_chain_tpu_torch p03` as a process over HRC001 in a copy of
     P2STR18 in its own directory: one decoder open
     and no stall pass, the canvas chunks' launches plus the PC context's
     420->422 lift (2 resize a composited chunk), both members committed;
     its wo_buffer AVPVS, .siti.csv and stalled AVPVS equal to (b)'s, its
     PC UYVY CPVS to (f)'s (byte-equal, else decoded-equal), and a p04
     process over the copy afterwards plans no job; frames/s and the
     decode, device and writeback seconds beside (b)'s and (f)'s; (h)
     p01 and p00 from a source video: P2STR180, a short test over (b)'s
     SRC000 and (c)'s SRC001 (rungs 640x360 at 30 fps, a drop from 60,
     and 1280x720 at the SRC's rate; a 0.5 s stall between HRC000's two
     1 s segments; the 10-bit SRC at 720p; the pc context at 1920x1080),
     coded with the first of libvpx-vp9, libx265, libaom-av1 and libx264
     that opens (two passes where the encoder keeps its own statistics or
     its round trip at load passed; SRC000 without audio where no aac
     encoder is bound): the port's p01 stage in this process on cuda:0
     and again on the CPU, models.segments' writer replaced by a
     recording writer: every u8 encoder-input plane's sha1 equal (u16
     within a code value), every segment's frame count the plan's, 3
     resize launches a chunk on the card; then, where an encoder of the
     four opens, `python -m processing_chain_tpu_torch p00` as a process:
     every segment probes at its planned geometry, pixel format, rate and
     frame count, the four metadata files exist with the segments' frame
     counts and the HRC's .buff events, each AVPVS and PC CPVS equals the
     port's render of the same segment files on the CPU in this process,
     p01's, p03's and p04's launches as planned, and a warm p00 in this
     process plans no job (else one line says that no encoder opens).
     (h)'s p01 runs beside (b)'s p03 process; (b)'s and (c)'s CLI calls
     end before (e)'s and (f)'s processes start together and run beside
     the checks of (b)-(d); (g)'s and (h)'s start once (e) is checked,
     beside (f)'s, and the CPU's reference render of (h) runs in a thread
     once (h)'s process has ended; their own checks follow. The launch
     counts join `paths` as p03_file, p03_file_10bit, p03_file_long,
     p04_file, p03_file_fused, p01_file (the in-process card run) and,
     where its process ran, p00_file
`--steadiness N` runs no phase: it repeats phase 16's three wall-clock
gates N times as processes (the pack bench's e2e tail, the chaos self-test's
and the chaos run's 50 ms warm p50), in turns over this checkout and each
`--against` checkout (a parent unpacked beside it), their roots where phase
16 puts them; it logs each reading and the failures by gate and checkout.
Phase 15 (a), phase 16, phase 18 and `--steadiness` root their state in a
fresh directory under /dev/shm (tmpfs on the card's host; tempfile.mkdtemp,
removed after), whose mount, filesystem type (/proc/mounts) and free bytes
their first line names: phase 16's wall-clock budgets then measure the
serve logic with its durable writes and fsyncs, and phase 18's stage
CLIs the render, not the checkout's 9p mount. A phase fails,
naming the reason, where that directory cannot be made. Each phase's start
logs the smoke's elapsed seconds, and the line before the result lines is
`chip_smoke: phases 1-18 in <s> s`.
Each path's launch counts are set to 0 just before it runs and read just
after (phase 18's in the stage process, which reports them). The last two
lines of standard output are one JSON object with every kernel's numbers
and `{"ok": true, "device": {...}}`. Phases 1-17 need neither PIL nor a
media file; phase 18 reads the committed spinner PNG with PIL.
"""

from __future__ import annotations

import contextlib
import filecmp
import hashlib
import itertools
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import torch

from processing_chain_tpu_torch.config import PostProcessing, StaticProber, TestConfig
from processing_chain_tpu_torch.engine import prefetch as pfe
from processing_chain_tpu_torch.io import medialib
from processing_chain_tpu_torch.io import probe as io_probe
from processing_chain_tpu_torch.io.video import VideoReader, VideoWriter
from processing_chain_tpu_torch.models import avpvs, fused, segments
from processing_chain_tpu_torch.models import cpvs as cp
from processing_chain_tpu_torch.models import frames as fr
from processing_chain_tpu_torch.ops import _build
from processing_chain_tpu_torch.ops import cuda_kernels as ck
from processing_chain_tpu_torch.ops import fps as fps_ops
from processing_chain_tpu_torch.ops import metrics as metrics_ops
from processing_chain_tpu_torch.ops import overlay as ov
from processing_chain_tpu_torch.ops import pixfmt as pf
from processing_chain_tpu_torch.ops import resize as resize_ops
from processing_chain_tpu_torch.parallel import mesh as pmesh
from processing_chain_tpu_torch.parallel import meshobs, p03_batch, pipeline
from processing_chain_tpu_torch.priors import features as prior_features
from processing_chain_tpu_torch import telemetry as serve_tm
from processing_chain_tpu_torch.telemetry import alerts as serve_alerts
from processing_chain_tpu_torch.telemetry import fleet as serve_fleet
from processing_chain_tpu_torch.telemetry import live as serve_live
from processing_chain_tpu_torch.telemetry import profiling
from processing_chain_tpu_torch.telemetry import watchdog
from processing_chain_tpu_torch.utils import fsio, lockdebug, plandebug, tracing
from processing_chain_tpu_torch.serve import api as serve_api
from processing_chain_tpu_torch.serve import cost as serve_cost
from processing_chain_tpu_torch.serve import spans as serve_spans
from processing_chain_tpu_torch.serve.executors import DeviceWaveExecutor
from processing_chain_tpu_torch.serve.service import ChainServeService
from processing_chain_tpu_torch.store import keys
from processing_chain_tpu_torch.store.store import ArtifactStore
from processing_chain_tpu_torch.tools import quality_metrics as qm
from processing_chain_tpu_torch.tools import serve_chaos, serve_soak, src_analysis

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
SRC_H, SRC_W, DST_H, DST_W = 1080, 1920, 2160, 3840
CLIP_FRAMES, CLIP_FRAMES_10BIT = 600, 128  # a 10 s 60 fps short test; 2 chunks
FLAGSHIP_FRAMES = 64
WAVE_CASES = (  # (label, lane lengths, 4-lane mesh on the card?)
    ("production", (600, 250), False),
    ("4lane", (200, 130, 100, 64, 40), True),
)
CANVAS_FPS = 60.0
MOBILE_H, MOBILE_W = 1080, 1920
# the downstream render's resize geometries, [dtype, max, source, output,
# kernel, resize_ring?]: the CPVS downscale of the three planes
# (resize_stream: 8 taps) and the 420->422 chroma lift, u8 and 10-bit (a
# ring plan: 2 taps, one of them weighted 0 on the identity width axis);
# then p01's quality ladder from a 2160p yuv420p source to 1280x720,
# 640x360 and 320x180 (resize_stream: 11, 24 and 48 bicubic taps a pass;
# 70 for lanczos), luma and chroma, and one 10-bit plane
LADDER = ((720, 1280), (360, 640), (180, 320))
DOWNSTREAM_RESIZES = (
    (torch.uint8, 255, (DST_H, DST_W), (MOBILE_H, MOBILE_W), "bicubic", False),
    (torch.uint8, 255, (MOBILE_H, MOBILE_W), (MOBILE_H // 2, MOBILE_W // 2), "bicubic", False),
    (torch.uint8, 255, (DST_H // 2, DST_W // 2), (DST_H, DST_W // 2), "bilinear", True),
    (torch.uint16, 1023, (DST_H // 2, DST_W // 2), (DST_H, DST_W // 2), "bilinear", True),
    *((torch.uint8, 255, (DST_H, DST_W), (h, w), "bicubic", False) for h, w in LADDER),
    *((torch.uint8, 255, (DST_H // 2, DST_W // 2), (h // 2, w // 2), "bicubic", False)
      for h, w in LADDER),
    (torch.uint8, 255, (DST_H, DST_W), LADDER[2], "lanczos", False),
    (torch.uint16, 1023, (DST_H, DST_W), LADDER[1], "bicubic", False),
)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor)
# operations/s; int32 add and multiply-add run at half the fp32 rate
# (64 vs 128 per SM per clock on compute capability 9.0).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
INT32_OPS_S = FP32_OPS_S / 2
SI_OPS_PER_PX = 14  # separable Sobel 8, m² 3, sqrt 1, two sums 2
TI_OPS_PER_PX = 4   # difference, square, two sums
# SI work is priced at the fp32 rate: the strip walk (the SI pass and the
# fused pass alike) runs it in f32, exact for u8 samples (u16 chunks are
# bound by their bytes at either rate); TI work at the int32 rate, on which
# ti_partials and the fused pass run it.

# The redesigned kernels' previous design, for the reader: its phase-7 time
# as PERF.md's kernel table records it (NVIDIA H100 80GB HBM3, 700.00 W).
# Not measured by this run, so it goes to the log line only, never into the
# kernels line.
_PREV_SRC = "PERF.md kernel table, previous design"
PREVIOUS = {
    "resize_frames_fused": {"previous_ms": 3.6221, "previous_from": _PREV_SRC},
    "resize_frames_fused cpvs_downscale": {"previous_ms": 19.0104, "previous_from": _PREV_SRC},
    "si_frames_fused": {"previous_ms": 1.8736, "previous_from": _PREV_SRC},
    "siti_frames_fused_batch": {"previous_ms": 1.7771, "previous_from": _PREV_SRC},
    "siti_frames_fused": {"previous_ms": 1.7725, "previous_from": _PREV_SRC},
}

KERNELS = {
    "resize_frames_fused": ("csrc/resize.cu", "pallas_kernels.py:135"),
    "si_frames_fused": ("csrc/siti.cu", "pallas_kernels.py:293"),
    "ti_frames_fused": ("csrc/siti.cu", "pallas_kernels.py:443"),
    "siti_frames_fused_batch": ("csrc/siti.cu", "pallas_kernels.py:398"),
    "siti_frames_fused": ("csrc/siti.cu", "pallas_kernels.py:355"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


#: where the wall-clock gates' state lives: tmpfs on the card's host, not
#: the checkout's mount (PERF.md §6, PR 17's diagnosis)
RAM_BASE = "/dev/shm"


def host_load() -> str:
    """The host's load average, its runnable/total processes, and the
    processes this run started that still live, by name (read from /proc;
    information only): what shares the CPU with a wall-clock gate."""
    try:
        with open("/proc/loadavg") as f:
            fields = f.read().split()
        parent, name = {}, {}
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            head, _, tail = stat.rpartition(")")
            parent[int(entry)] = int(tail.split()[1])
            name[int(entry)] = head.partition("(")[2]
        mine, frontier = [], [os.getpid()]
        while frontier:
            kids = [c for c, p in parent.items() if p == frontier[-1]]
            frontier.pop()
            mine += kids
            frontier += kids
        names = sorted(name[c] for c in mine)
        return f"load {fields[0]} (1 min), runnable/processes {fields[3]}, live children {names}"
    except (OSError, ValueError, IndexError) as exc:
        return f"load unread ({exc})"


def mount_of(path: str) -> tuple:
    """(mount point, filesystem type) of the mount holding `path`, read
    from /proc/mounts (the longest mount point that prefixes it)."""
    real = os.path.realpath(path)
    best = ("/", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            point = fields[1].replace("\\040", " ")
            if (real == point or real.startswith(point.rstrip("/") + "/")) \
                    and len(point) >= len(best[0]):
                best = (point, fields[2])
    return best


@contextlib.contextmanager
def ram_root(label: str):
    """A fresh directory under RAM_BASE (tempfile.mkdtemp), removed after;
    logs it with its mount and filesystem type first. Fails, naming the
    reason, where it cannot be made there or RAM_BASE is not tmpfs."""
    try:
        root = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_", dir=RAM_BASE)
    except OSError as exc:
        raise SmokeFailure(f"{label}: cannot make a root under {RAM_BASE}: {exc}") from exc
    try:
        point, fstype = mount_of(root)
        st = os.statvfs(root)
        log(f"{label}: root {root} on {fstype} (mount {point}, "
            f"{st.f_bavail * st.f_frsize / 1e9:.1f} GB free)")
        require(fstype in ("tmpfs", "ramfs"),
                f"{label}: {RAM_BASE} is {fstype} (mount {point}), not RAM-backed")
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# cycles of the spin kernel that holds the stream while the host queues
# the calls time_ms_queued times (~25 ms at the H100's clocks)
SPIN_CYCLES = 50_000_000


def time_ms_queued(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per call of `fn`: a spin kernel holds the
    stream while the host queues `reps` calls, so the events time the
    card's work alone, without the host's launch cost between calls. The
    host ms is the enqueue's wall time per call; the device number is
    clean while reps times it stays under the spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def plane_shapes(t: int):
    return [(t, SRC_H, SRC_W), (t, SRC_H // 2, SRC_W // 2), (t, SRC_H // 2, SRC_W // 2)]


def random_frames(gen, shape, hi: int, dtype, device) -> torch.Tensor:
    x = torch.randint(0, hi + 1, shape, generator=gen, device=device, dtype=torch.int32)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain at the main path's shapes
# ---------------------------------------------------------------------------


def check_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {name: 0.0 for name in KERNELS}
    for kernel in ("bicubic", "lanczos"):
        for (t, h, w), (dh, dw) in zip(plane_shapes(8)[:2], [(DST_H, DST_W), (DST_H // 2, DST_W // 2)]):
            x = random_frames(gen, (t, h, w), 255, torch.uint8, dev)
            a = ck.resize_frames_fused(x, dh, dw, kernel)
            b = ck.resize_frames_plain(x, dh, dw, kernel)
            e = max_abs(a, b)
            log(f"resize u8 {kernel} {h}x{w}->{dh}x{dw} x{t}: max|kernel-plain| = {e}")
            require(torch.equal(a, b), f"resize u8 {kernel} {h}x{w}: kernel != plain")
            err["resize_frames_fused"] = max(err["resize_frames_fused"], e)
    for (t, h, w), (dh, dw) in zip(plane_shapes(8)[:2], [(DST_H, DST_W), (DST_H // 2, DST_W // 2)]):
        x = random_frames(gen, (t, h, w), 1023, torch.uint16, dev)
        d = (ck.resize_frames_fused(x, dh, dw, "bicubic").to(torch.int32)
             - ck.resize_frames_plain(x, dh, dw, "bicubic").to(torch.int32)).abs()
        e, share = int(d.max()), float((d != 0).to(torch.float64).mean())
        log(f"resize u16 bicubic {h}x{w}->{dh}x{dw} x{t}: max diff {e}, "
            f"differing share {share}")
        require(e <= 1, f"resize u16 {h}x{w}: max diff {e} > 1")
        err["resize_frames_fused"] = max(err["resize_frames_fused"], float(e))
    for dtype, hi, atol in ((torch.uint8, 255, 1e-3), (torch.uint16, 1023, 1e-2)):
        y = random_frames(gen, (16, DST_H, DST_W), hi, dtype, dev)
        prev = random_frames(gen, (DST_H, DST_W), hi, dtype, dev)
        cases = [
            ("si_frames_fused", ck.si_frames_fused(y), ck.si_frames_plain(y)),
            ("ti_frames_fused", ck.ti_frames_fused(y), ck.ti_frames_plain(y)),
            ("ti_frames_fused", ck.ti_frames_fused(y, prev), ck.ti_frames_plain(y, prev)),
        ]
        for name, a, b in cases:
            e = max_abs(a, b)
            log(f"{name} {str(dtype)[6:]} [16,{DST_H},{DST_W}]: max|kernel-plain| = {e}")
            require(torch.allclose(a, b, rtol=1e-4, atol=atol),
                    f"{name} {dtype}: kernel vs plain off by {e}")
            err[name] = max(err[name], e)
        # the fused SI+TI kernels: against their plain versions and against
        # the separate SI and TI kernels on the same frames
        si, ti = ck.siti_frames_fused(y)
        psi, pti = ck.siti_frames_plain(y)
        si1, ti1 = ck.siti_frames_fused(y[:1].clone())
        require(ti1.tolist() == [0.0], f"1-frame clip: TI {ti1.tolist()} != [0]")
        yb = random_frames(gen, (2, 8, DST_H, DST_W), hi, dtype, dev)
        prevb = random_frames(gen, (2, DST_H, DST_W), hi, dtype, dev)
        sib, tib = ck.siti_frames_fused_batch(yb, prevb)
        psib, ptib = ck.siti_frames_batch_plain(yb, prevb)
        halo = yb[:, 0].contiguous()
        sih, tih = ck.siti_frames_fused_batch(yb, halo)
        psih, ptih = ck.siti_frames_batch_plain(yb, halo)
        require(tih[:, 0].tolist() == [0.0, 0.0], "self-halo: TI[:, 0] != 0")
        sep_b = (torch.stack([ck.si_frames_fused(yb[k]) for k in range(2)]),
                 torch.stack([ck.ti_frames_fused(yb[k], prevb[k]) for k in range(2)]))
        cases = [
            ("siti_frames_fused", "[16] vs plain", (si, ti), (psi, pti)),
            ("siti_frames_fused", "[16] vs separate kernels", (si, ti),
             (ck.si_frames_fused(y), ck.ti_frames_fused(y))),
            ("siti_frames_fused", "[1] vs plain", (si1, ti1), ck.siti_frames_plain(y[:1])),
            ("siti_frames_fused_batch", "[2,8] vs plain", (sib, tib), (psib, ptib)),
            ("siti_frames_fused_batch", "[2,8] vs separate kernels", (sib, tib), sep_b),
            ("siti_frames_fused_batch", "[2,8] self-halo vs plain", (sih, tih), (psih, ptih)),
        ]
        for name, what, got, want in cases:
            e = max(max_abs(a, b) for a, b in zip(got, want))
            log(f"{name} {str(dtype)[6:]} {what} at {DST_H}x{DST_W}: max|diff| = {e}")
            require(all(torch.allclose(a, b, rtol=1e-4, atol=atol) for a, b in zip(got, want)),
                    f"{name} {dtype} {what}: off by {e}")
            err[name] = max(err[name], e)
        del y, prev, yb, prevb, halo
    for dtype, hi, (h, w), (dh, dw), kernel, ring in DOWNSTREAM_RESIZES:
        x = random_frames(gen, (8, h, w), hi, dtype, dev)
        exact = ck._exact_route(dtype, h, w, dh, dw, kernel)
        plan = ck._resize_plan(h, w, dh, dw, kernel, exact, x.element_size())
        what = f"resize {str(dtype)[6:]} {kernel} {h}x{w}->{dh}x{dw} x8"
        require(plan["ring"] == ring,
                f"{what}: takes {'resize_ring' if plan['ring'] else 'resize_stream'}")
        a = ck.resize_frames_fused(x, dh, dw, kernel)
        b = ck.resize_frames_plain(x, dh, dw, kernel)
        e = max_abs(a, b)
        route = "resize_ring" if ring else (
            f"resize_stream, {plan['tile_w']}x{plan['tile_h']} tiles, "
            f"{plan['smem_bytes']} B shared")
        log(f"{what} ({route}, kh {plan['kh']}, kv {plan['kv']}): max|kernel-plain| = {e}")
        require(torch.equal(a, b), f"{what}: kernel != plain")
        err["resize_frames_fused"] = max(err["resize_frames_fused"], e)
        del x, a, b
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


class SyntheticSrc:
    """A seeded synthetic source of src_h x src_w yuv420p planes: frame k
    is a gradient shifted by 4k columns plus one of 8 noise fields (the
    (k % 8)-th), so SI and TI are non-trivial. Frames are made on demand,
    so a long 2160p source never sits in host memory whole."""

    def __init__(self, frames: int, ten_bit: bool, seed: int,
                 src_h: int = SRC_H, src_w: int = SRC_W):
        rng = np.random.default_rng(seed)
        self.dtype, hi = (np.uint16, 1023) if ten_bit else (np.uint8, 255)
        self.frames = frames
        self.shapes = [(src_h, src_w), (src_h // 2, src_w // 2), (src_h // 2, src_w // 2)]
        self.planes = []
        for h, w in self.shapes:
            xx = np.arange(w + 4 * frames)[None, :]
            yy = np.arange(h)[:, None]
            grad = ((xx * 3 + yy * 2) % (hi - 40)).astype(self.dtype)
            noise = rng.integers(0, 41, (8, h, w)).astype(self.dtype)
            self.planes.append((grad, noise))

    def chunks(self, start: int, n: int, chunk: int):
        """Host chunks (lists of [T, H, W] planes) of frames start..start+n-1."""
        for lo in range(start, start + n, chunk):
            t = min(chunk, start + n - lo)
            out = []
            for (grad, noise), (h, w) in zip(self.planes, self.shapes):
                arr = np.empty((t, h, w), self.dtype)
                for k in range(t):
                    s = 4 * (lo + k)
                    np.add(grad[:, s:s + w], noise[(lo + k) % 8], out=arr[k])
                out.append(arr)
            yield out


def synthetic_clip(frames: int, chunk: int, ten_bit: bool, seed: int,
                   src_h: int = SRC_H, src_w: int = SRC_W) -> list:
    """All host chunks of a `SyntheticSrc` of `frames` frames. The first n
    frames of a clip do not depend on its length."""
    return list(SyntheticSrc(frames, ten_bit, seed, src_h, src_w).chunks(0, frames, chunk))


def fold_checksum(checksum: int, host_planes) -> int:
    """Running checksum: each plane's bytes summed as uint64 words (mod
    2**64), folded into the running value."""
    for h in host_planes:
        raw = (h.numpy() if isinstance(h, torch.Tensor) else h).reshape(-1).view(np.uint8)
        words = raw[: raw.size // 8 * 8].view(np.uint64)
        s = int(words.sum(dtype=np.uint64)) + int(raw[words.size * 8:].sum())
        checksum = (checksum * 1000003 + s) % (1 << 64)
    return checksum


def host_breakdown(dev, host_planes, quant_planes) -> dict:
    """Per-chunk cost of each host-side step of the render, measured one
    at a time on chunk 0: numpy -> pinned staging copy, host->device copy,
    device->host copy of the quantized planes, the sink's checksum."""
    pinned_in = [torch.empty(p.shape, dtype=torch.from_numpy(p).dtype, pin_memory=True)
                 for p in host_planes]
    pinned_out = [torch.empty(q.shape, dtype=q.dtype, pin_memory=True) for q in quant_planes]
    dev_in = [torch.empty(p.shape, dtype=p.dtype, device=dev) for p in pinned_in]

    def wall_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    def stage():
        for dst, src in zip(pinned_in, host_planes):
            dst.copy_(torch.from_numpy(src))

    def h2d():
        for dst, src in zip(dev_in, pinned_in):
            dst.copy_(src, non_blocking=True)

    def d2h():
        for dst, src in zip(pinned_out, quant_planes):
            dst.copy_(src, non_blocking=True)

    in_bytes = sum(p.nbytes for p in host_planes)
    out_bytes = sum(q.numel() * q.element_size() for q in quant_planes)
    out = {
        "stage_ms": wall_ms(stage),
        "h2d_ms": time_ms(h2d, reps=3),
        "d2h_ms": time_ms(d2h, reps=3),
        "checksum_ms": wall_ms(lambda: fold_checksum(0, pinned_out)),
        "h2d_bytes": in_bytes, "d2h_bytes": out_bytes,
    }
    out["h2d_gb_s"] = in_bytes / out["h2d_ms"] / 1e6
    out["d2h_gb_s"] = out_bytes / out["d2h_ms"] / 1e6
    return out


class HostSink:
    """The writer end of the main path: fetches every quantized chunk to
    pinned host memory on its own stream, on a thread of its own, and folds
    it into a running checksum. The host copies of the chunks numbered in
    `keep` are kept (the first, by default)."""

    def __init__(self, device, keep=(0,)):
        self.stream = torch.cuda.Stream(device)
        self.queue = queue.Queue(maxsize=2)
        self.checksum = 0
        self.frames = 0
        self.chunks = 0
        self.keep = set(keep)  # chunk indices whose host copy is kept
        self.kept = {}
        self.error = None
        self.fetch_s = 0.0     # wall time of the device->host copies
        self.checksum_s = 0.0  # wall time of the host checksum
        self._bufs = {}
        self._thread = threading.Thread(target=self._run, name="host-sink")
        self._thread.start()

    def put(self, planes, recycle=None) -> None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream())
        self.queue.put((planes, done))

    def _run(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            if self.error is not None:
                continue
            try:
                self._fetch(*item)
            except BaseException as exc:  # reported by close()
                self.error = exc

    def _fetch(self, planes, done) -> None:
        host = []
        done.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(done)
            for k, p in enumerate(planes):
                key = (k, tuple(p.shape), p.dtype)
                buf = self._bufs.get(key)
                if buf is None:
                    buf = self._bufs[key] = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                buf.copy_(p, non_blocking=True)
                host.append(buf)
        self.stream.synchronize()
        t1 = time.perf_counter()
        self.checksum = fold_checksum(self.checksum, host)
        self.fetch_s += t1 - t0
        self.checksum_s += time.perf_counter() - t1
        self.frames += planes[0].shape[0]
        if self.chunks in self.keep:
            self.kept[self.chunks] = [h.clone() for h in host]
        self.chunks += 1

    @property
    def first(self):
        return self.kept.get(0)

    def close(self) -> None:
        self.queue.put(None)
        self._thread.join()
        if self.error is not None:
            raise self.error


def run_main_path(dev, frames: int, pix_fmt: str, workdir: str) -> dict:
    ten_bit = "10" in pix_fmt
    chunk = avpvs.CHUNK
    chunks = synthetic_clip(frames, chunk, ten_bit, SEED + frames)
    n_chunks = len(chunks)
    out_path = os.path.join(workdir, f"smoke_{pix_fmt}.avi")
    avpvs.SiTiAccumulator.discard(out_path)
    feat = avpvs.SiTiAccumulator()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    ck.reset_launches()
    t0 = time.perf_counter()
    sink = HostSink(dev)
    try:
        avpvs.pump_ready(iter(chunks), sink, feat, DST_H, DST_W, pix_fmt, device=dev)
    finally:
        sink.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    log(f"main path {pix_fmt}: {frames} frames in {n_chunks} chunks, "
        f"{seconds:.3f} s, launches {launches}")
    require(sink.frames == frames, f"sink saw {sink.frames} frames, not {frames}")
    want = launches_want(resize_frames_fused=3 * n_chunks, si_frames_fused=n_chunks,
                         ti_frames_fused=n_chunks)
    require(launches == want, f"launches {launches} != {want}")

    path = feat.write(out_path)
    with open(path) as f:
        rows = f.read().splitlines()
    require(rows[0] == "frame,si,ti" and len(rows) == frames + 1,
            f"sidecar has {len(rows) - 1} rows, not {frames}")
    si = torch.cat(feat.si).cpu()
    ti = torch.cat(feat.ti).cpu()
    require(bool(torch.isfinite(si).all() and torch.isfinite(ti).all()), "non-finite SI/TI")
    require(float(ti[0]) == 0.0 and bool((ti[1:] > 0).all()) and bool((si > 0).all()),
            "SI/TI of the moving noisy gradient must be positive (TI[0] = 0)")

    # the first chunk again, through the plain versions on the card
    first_dev = [torch.from_numpy(p).to(dev) for p in chunks[0]]
    sub = fr.chroma_subsampling(pix_fmt)
    dims = [(DST_H, DST_W), (DST_H // sub[0], DST_W // sub[1]), (DST_H // sub[0], DST_W // sub[1])]
    plain = [ck.resize_frames_plain(p, h, w, "bicubic") for p, (h, w) in zip(first_dev, dims)]
    plane_err = max(max_abs(a, b.cpu()) for a, b in zip(sink.first, plain))
    if ten_bit:
        require(plane_err <= 1, f"10-bit first chunk: max diff {plane_err} > 1")
    else:
        require(all(torch.equal(a, b.cpu()) for a, b in zip(sink.first, plain)),
                "u8 first chunk differs from the plain path")
    atol = 1e-2 if ten_bit else 1e-3
    n0 = chunks[0][0].shape[0]
    si_err = max_abs(si[:n0], ck.si_frames_plain(plain[0]).cpu())
    ti_err = max_abs(ti[:n0], ck.ti_frames_plain(plain[0]).cpu())
    require(si_err <= atol and ti_err <= atol, f"first chunk SI/TI off by {si_err}, {ti_err}")

    # device time of one chunk's render (resize x3, quantize, SI, TI),
    # the chunk already resident
    def render_chunk():
        scaled = fr.scale_yuv_frames(first_dev, DST_H, DST_W, "bicubic", sub)
        quant = fr.quantize_device(scaled, ten_bit)
        avpvs.SiTiAccumulator().update(quant[0])

    device_ms = time_ms(render_chunk, reps=5)
    scaled = fr.scale_yuv_frames(first_dev, DST_H, DST_W, "bicubic", sub)
    breakdown = host_breakdown(dev, chunks[0], fr.quantize_device(scaled, ten_bit))
    del scaled
    result = {
        "pix_fmt": pix_fmt, "frames": frames, "chunks": n_chunks,
        "seconds": seconds, "frames_per_s": frames / seconds,
        "device_ms_per_chunk": device_ms,
        "device_ms_per_frame": device_ms / n0,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "launches": launches, "first_chunk_max_err": plane_err,
        "first_chunk_si_err": si_err, "first_chunk_ti_err": ti_err,
        "checksum": f"{sink.checksum:016x}",
        "sink_fetch_s": sink.fetch_s, "sink_checksum_s": sink.checksum_s,
        "device_busy_share": device_ms * n_chunks / 1e3 / seconds,
        "per_chunk_host": breakdown,
    }
    log(f"main path {pix_fmt}: {result['frames_per_s']:.2f} frames/s end to end, "
        f"device {device_ms:.3f} ms per {n0}-frame chunk; sink fetch "
        f"{sink.fetch_s:.3f} s + checksum {sink.checksum_s:.3f} s; one chunk's "
        f"host steps {json.dumps(breakdown)}")
    del first_dev, plain
    torch.cuda.empty_cache()
    return result


def counted(fn):
    """Run `fn` with every launch count set to 0 just before and read just
    after: (its result, the launches it made, its wall seconds)."""
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ck.LAUNCHES), time.perf_counter() - t0


def launches_want(**nonzero) -> dict:
    return {name: nonzero.get(name, 0) for name in ck.LAUNCHES}


# ---------------------------------------------------------------------------
# phase 5: the flagship step
# ---------------------------------------------------------------------------


def run_flagship(dev) -> dict:
    """avpvs_siti_step on seeded u8 planes, 1080p -> 2160p lanczos, once
    without prev_last and once with the first call's last luma frame."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    planes = [random_frames(gen, s, 255, torch.uint8, dev) for s in plane_shapes(FLAGSHIP_FRAMES)]
    dims = [(DST_H, DST_W), (DST_H // 2, DST_W // 2), (DST_H // 2, DST_W // 2)]
    result = {}
    prev = None
    for name in ("flagship", "flagship_prev"):
        out, launches, _ = counted(
            lambda: pipeline.avpvs_siti_step(*planes, DST_H, DST_W, prev_last=prev))
        up, (si, ti) = out[:3], out[3:]
        fused = "siti_frames_fused" if prev is None else "siti_frames_fused_batch"
        want = launches_want(resize_frames_fused=3, **{fused: 1})
        log(f"{name}: launches {launches}")
        require(launches == want, f"{name}: launches {launches} != {want}")
        for p, u, (h, w) in zip(planes, up, dims):
            require(torch.equal(u, ck.resize_frames_plain(p, h, w, "lanczos")),
                    f"{name}: a {h}x{w} plane differs from the plain resize")
        if prev is None:
            psi, pti = ck.siti_frames_plain(up[0])
        else:
            psi, pti = ck.si_frames_plain(up[0]), ck.ti_frames_plain(up[0], prev)
        e = max(max_abs(si, psi), max_abs(ti, pti))
        require(torch.allclose(si, psi, rtol=1e-4, atol=1e-3)
                and torch.allclose(ti, pti, rtol=1e-4, atol=1e-3),
                f"{name}: SI/TI off the plain versions by {e}")
        require((float(ti[0]) == 0.0) == (prev is None), f"{name}: TI[0] = {float(ti[0])}")
        p_last = prev
        ms = time_ms(lambda: pipeline.avpvs_siti_step(*planes, DST_H, DST_W, prev_last=p_last),
                     reps=5)
        result[name] = {"launches": launches, "siti_max_err": e, "device_ms_per_call": ms,
                        "frames": FLAGSHIP_FRAMES}
        log(f"{name}: {ms:.4f} ms per {FLAGSHIP_FRAMES}-frame call on the device, "
            f"SI/TI max|kernel-plain| {e}")
        prev = up[0][-1].clone()
        del out, up
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 6: the wave render
# ---------------------------------------------------------------------------


class LaneSink:
    """A lane's emit end: counts frames, keeps the first block (the wave
    loop never writes emitted memory again) and the features."""

    def __init__(self) -> None:
        self.frames = 0
        self.first = None
        self.feat = avpvs.SiTiAccumulator()

    def emit(self, planes) -> None:
        if self.first is None:
            self.first = planes
        self.frames += planes[0].shape[0]


class DropSink:
    def put(self, planes, recycle=None) -> None:
        pass


def single_features(dev, chunks) -> tuple:
    """SI/TI of one clip rendered alone through pump_ready (u8)."""
    feat = avpvs.SiTiAccumulator()
    avpvs.pump_ready(iter(chunks), DropSink(), feat, DST_H, DST_W, "yuv420p", device=dev)
    return torch.cat(feat.si).cpu().numpy(), torch.cat(feat.ti).cpu().numpy()


def run_wave(dev, label: str, lengths, four_lanes: bool, workdir: str) -> dict:
    chunk = avpvs.CHUNK
    mesh = pmesh.make_mesh([dev] * 4) if four_lanes else pmesh.make_mesh()
    n_pvs = mesh.shape["pvs"]
    clips = [synthetic_clip(n, chunk, False, SEED + 31 * i + n) for i, n in enumerate(lengths)]
    sinks = [LaneSink() for _ in lengths]
    lanes = [p03_batch.Lane(chunks=iter(c), emit=s.emit, n_frames_hint=n,
                            emit_features=s.feat.extend, name=f"{label}{i}")
             for i, (c, s, n) in enumerate(zip(clips, sinks, lengths))]
    journal = os.path.join(workdir, f"meshobs_{label}")
    shutil.rmtree(journal, ignore_errors=True)
    meshobs.attach_journal(journal)
    bucket = p03_batch.bucket_label(DST_H, DST_W, False, SRC_H, SRC_W)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        _, launches, seconds = counted(lambda: p03_batch.run_bucket(
            lanes, mesh, DST_H, DST_W, "bicubic", (2, 2), False, chunk=chunk, bucket=bucket))
    finally:
        meshobs.detach_journal()
    frames = sum(lengths)
    log(f"wave {label}: {frames} frames, lanes {list(lengths)} on pvs={n_pvs}, "
        f"{seconds:.3f} s, launches {launches}")

    order = sorted(lengths, reverse=True)
    blocks = sum(-(-max(order[w:w + n_pvs]) // chunk) for w in range(0, len(order), n_pvs))
    want = launches_want(resize_frames_fused=3 * blocks, siti_frames_fused_batch=blocks)
    require(launches == want, f"wave {label}: launches {launches} != {want}")
    agg = meshobs.aggregate(journal)
    tot = agg["totals"]
    pads = {k: tot[k] for k in meshobs.SLOT_KINDS[1:]}
    require(agg["invariant_violations"] == 0 and tot["waves"] == blocks
            and tot["valid"] == frames
            and tot["valid"] + sum(pads.values()) == tot["dispatched"] == blocks * n_pvs * chunk,
            f"wave {label}: slot accounting {tot}")
    if four_lanes:
        require(all(v > 0 for v in pads.values()), f"wave {label}: pads {pads}")

    sidecar_rows = []
    lane_err = {"si": 0.0, "ti": 0.0}
    for i, (clip, sink, n) in enumerate(zip(clips, sinks, lengths)):
        require(sink.frames == n, f"wave {label} lane {i}: {sink.frames} frames, not {n}")
        first_dev = [torch.from_numpy(p).to(dev) for p in clip[0]]
        dims = [(DST_H, DST_W), (DST_H // 2, DST_W // 2), (DST_H // 2, DST_W // 2)]
        for got, p, (h, w) in zip(sink.first, first_dev, dims):
            plain = ck.resize_frames_plain(p, h, w, "bicubic").cpu().numpy()
            require(got.shape == plain.shape and np.array_equal(got, plain),
                    f"wave {label} lane {i}: first block differs from the plain resize")
        del first_dev
        si = np.concatenate([np.asarray(x) for x in sink.feat.si])
        ti = np.concatenate([np.asarray(x) for x in sink.feat.ti])
        ssi, sti = single_features(dev, clip)
        lane_err["si"] = max(lane_err["si"], float(np.abs(si - ssi).max()))
        lane_err["ti"] = max(lane_err["ti"], float(np.abs(ti - sti).max()))
        require(np.allclose(si, ssi, rtol=1e-4, atol=1e-3) and np.allclose(ti, sti, rtol=1e-4, atol=1e-3)
                and ti[0] == 0.0,
                f"wave {label} lane {i}: SI/TI off the lane rendered alone by {lane_err}")
        path = sink.feat.write(os.path.join(workdir, f"wave_{label}{i}.avi"))
        with open(path) as f:
            rows = f.read().splitlines()
        require(rows[0] == "frame,si,ti" and len(rows) == n + 1,
                f"wave {label} lane {i}: sidecar has {len(rows) - 1} rows, not {n}")
        sidecar_rows.append(len(rows) - 1)
    result = {
        "label": label, "lanes": list(lengths), "n_pvs": n_pvs, "blocks": blocks,
        "frames": frames, "seconds": seconds, "frames_per_s": frames / seconds,
        "launches": launches, "slots": {k: tot[k] for k in ("valid", "dispatched")} | pads,
        "step_s_sum": tot["step_s"], "first_dispatch_s": tot["compile_s"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "lane_vs_single_max_err": lane_err, "sidecar_rows": sidecar_rows,
    }
    log(f"wave {label}: {result['frames_per_s']:.2f} frames/s end to end "
        f"(host<->device copies included), slots {result['slots']}, "
        f"steps {tot['step_s']} s, lane vs single max err {lane_err}")
    del clips, sinks, lanes
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 7: the downstream render (stall composite + CPVS transforms)
# ---------------------------------------------------------------------------


def synthetic_spinner(seed: int) -> np.ndarray:
    """A seeded 128x128 RGBA spinner: a ring whose alpha fades along its
    circumference (so each rotation phase differs) and whose color is
    noise, built in numpy so that the smoke needs no PIL."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:128, 0:128] - 63.5
    ring = np.clip(1.0 - np.abs(np.hypot(yy, xx) - 44.0) / 12.0, 0.0, 1.0)
    tail = (np.arctan2(yy, xx) + np.pi) / (2 * np.pi)
    rgba = np.empty((128, 128, 4), np.uint8)
    rgba[..., :3] = rng.integers(150, 256, (128, 128, 3))
    rgba[..., 3] = np.round(255 * ring * tail)
    return rgba


def pc_plan(fps: float, ten_bit: bool) -> dict:
    """`cpvs_plan`'s record for a PC context at the AVPVS's own size."""
    return {"context": "pc", "fps": float(fps), "normalize": False, "t": None,
            "vcodec": "v210" if ten_bit else "rawvideo",
            "pix_fmt": "yuv422p10le" if ten_bit else "uyvy422",
            "pad": None, "scale": None, "audio": None}


def mobile_plan() -> dict:
    """`cpvs_plan`'s record for a mobile context scaled to 1920x1080."""
    return {"context": "mobile", "fps": None, "normalize": False, "t": None,
            "vcodec": "libx264", "pix_fmt": "yuv420p", "crf": 17, "preset": "fast",
            "profile": "high", "pad": None, "scale": (MOBILE_W, MOBILE_H), "audio": None}


def downstream_contexts(ten_bit: bool, pc_fps: float) -> list:
    """(name, post-processing, plan, resize launches per output chunk) of
    the two contexts: a PC one on the 3840x2160 canvas at `pc_fps` and a
    mobile one at 1920x1080."""
    pc = PostProcessing(None, {"type": "pc", "displayWidth": DST_W, "displayHeight": DST_H,
                               "codingWidth": DST_W, "codingHeight": DST_H,
                               "displayFrameRate": pc_fps})
    mobile = PostProcessing(None, {"type": "mobile", "displayWidth": MOBILE_W,
                                   "displayHeight": MOBILE_H, "codingWidth": MOBILE_W,
                                   "codingHeight": MOBILE_H})
    return [("pc_v210" if ten_bit else "pc_uyvy", pc, pc_plan(pc_fps, ten_bit), 2),
            ("mobile", mobile, mobile_plan(), 3)]


def fps_frames(n: int, src_fps: float, dst_fps: float) -> int:
    """Output frames of the `fps=` resample of n frames: every output whose
    source index is in the stream, padded to round(n / src * dst)."""
    k = 0
    while int(np.floor(k / dst_fps * src_fps + 0.5)) <= n - 1:
        k += 1
    return max(k, int(round(n / src_fps * dst_fps)))


class KeepSink:
    """A writer that keeps every chunk it is given, where it lies (on the
    card or the host), and hands each to `forward` when one is given: a
    fan-out's `feed`, a writeback stand-in's `put`."""

    def __init__(self, forward=None):
        self.forward = forward
        self.chunks = []

    def put(self, planes, recycle=None):
        self.chunks.append(planes)
        if self.forward is not None:
            self.forward(planes)

    def close(self):
        pass

    @property
    def frames(self) -> int:
        return sum(c[0].shape[0] for c in self.chunks)



def run_downstream_both(dev) -> dict:
    """Phase 7: the u8 clip with two stalls, then the 10-bit clip with a
    freeze (see the module doc)."""
    return {
        "u8": run_downstream(dev, "u8 stall", CLIP_FRAMES, "yuv420p",
                             [[2.0, 1.0], [7.5, 0.5]], False, pc_fps=30.0, preview=True,
                             want_frames=690),
        "10bit": run_downstream(dev, "10-bit freeze", CLIP_FRAMES_10BIT, "yuv420p10le",
                                [[0.5, 0.4]], True, pc_fps=CANVAS_FPS, preview=False,
                                want_frames=CLIP_FRAMES_10BIT),
    }


def run_downstream(dev, label: str, frames: int, pix_fmt: str, events, skipping: bool,
                   pc_fps: float, preview: bool, want_frames: int) -> dict:
    ten_bit = "10" in pix_fmt
    chunk = avpvs.CHUNK
    src = synthetic_clip(frames, chunk, ten_bit, SEED + frames)  # phase 4's clip
    rgba = synthetic_spinner(SEED + 5)
    plan = ov.plan_stalling(frames, CANVAS_FPS, events, skipping=skipping)
    first_stall = int(np.flatnonzero(plan.stall_mask)[0]) // chunk
    comp = avpvs.make_stall_compositor(pix_fmt, rgba, skipping, 64, device=dev)
    contexts = downstream_contexts(ten_bit, pc_fps)
    stalled = HostSink(dev, keep={0, 1, first_stall})
    sinks = {name: HostSink(dev) for name, *_ in contexts}
    pipes = [fused._ContextPipeline(sinks[name], p, pp, pix_fmt, CANVAS_FPS, False, chunk)
             for name, pp, p, _ in contexts]
    per_chunk = {name: n for name, _, _, n in contexts}
    if preview:
        sinks["preview"] = HostSink(dev)
        pipes.append(fused._PreviewPipeline(sinks["preview"], pix_fmt))
        per_chunk["preview"] = 2 if "420" in pix_fmt else 0
    fan = fused.FanoutStream(pipes, compositor=comp, stall_writer=stalled, fps=CANVAS_FPS,
                            events=events, skipping=skipping, chunk=chunk)
    tee = KeepSink(fan.feed)  # the staged route reads the chunks again

    def fused_route():
        try:
            avpvs.pump_ready(iter(src), tee, avpvs.SiTiAccumulator(), DST_H, DST_W,
                             pix_fmt, device=dev)
            fan.finish_streams()
        except BaseException:
            fan.abort()
            raise

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _, launches, seconds = counted(fused_route)
    peak = torch.cuda.max_memory_allocated(dev)
    n_src = len(src)
    log(f"downstream {label} fused: {frames} -> {stalled.frames} frames, {seconds:.3f} s, "
        f"launches {launches}, sinks {[(k, v.frames, v.chunks) for k, v in sinks.items()]}")
    require(stalled.frames == plan.n_out == want_frames,
            f"{label}: fused route wrote {stalled.frames} frames, plan {plan.n_out}, "
            f"want {want_frames}")
    want_resize = 3 * n_src + sum(per_chunk[k] * sinks[k].chunks for k in sinks)
    want = launches_want(resize_frames_fused=want_resize, si_frames_fused=n_src,
                         ti_frames_fused=n_src)
    require(launches == want, f"{label}: fused launches {launches} != {want}")
    # the PC context resamples to its display rate; the others keep 1:1
    want_ctx = {k: want_frames for k in sinks}
    want_ctx[contexts[0][0]] = fps_frames(want_frames, CANVAS_FPS, pc_fps)
    got_ctx = {k: v.frames for k, v in sinks.items()}
    require(got_ctx == want_ctx, f"{label}: context frames {got_ctx} != {want_ctx}")

    # the staged route over the same quantized frames, still on the card
    staged = HostSink(dev)

    def staged_route():
        try:
            avpvs.pump_stalled(pfe.iter_chunk_frames(tee.chunks), plan, comp, staged, chunk)
        finally:
            staged.close()

    _, staged_launches, staged_s = counted(staged_route)
    log(f"downstream {label} staged: {staged.frames} frames, {staged_s:.3f} s, "
        f"checksum {staged.checksum:016x} (fused {stalled.checksum:016x})")
    require(staged.frames == stalled.frames and staged.checksum == stalled.checksum,
            f"{label}: staged and fused stalled streams differ")
    require(staged_launches == launches_want(), f"{label}: staged launches {staged_launches}")

    # the first stall chunk, composited again through the plain path on the CPU
    t0 = time.perf_counter()
    lo = first_stall * chunk
    sel = plan.src_idx[lo: lo + chunk]
    gathered = [torch.stack([tee.chunks[k // chunk][p][k % chunk] for k in sel])
                for p in range(3)]
    masks = [m[lo: lo + len(sel)] for m in (plan.stall_mask, plan.black_mask, plan.phase)]
    cpu = avpvs.make_stall_compositor(pix_fmt, rgba, skipping, 64, device="cpu")(
        [g.cpu() for g in gathered], *masks)
    require(all(torch.equal(a, b) for a, b in zip(cpu, stalled.kept[first_stall])),
            f"{label}: stall chunk {first_stall} differs from the CPU composite")
    del cpu
    # each context's first chunk: its pipeline on the CPU over the kept
    # stalled chunks (a 30 fps context needs two)
    ctx_err = {}
    for name, pp, p, _ in contexts + ([("preview", None, None, 0)] if preview else []):
        sink = KeepSink()
        pipe = (fused._PreviewPipeline(sink, pix_fmt) if name == "preview" else
                fused._ContextPipeline(sink, p, pp, pix_fmt, CANVAS_FPS, False, chunk))
        for k in (0, 1):
            if not sink.chunks:
                pipe.feed(stalled.kept[k])
        got, ref = sinks[name].first, sink.chunks[0]
        ctx_err[name] = max(max_abs(a, b) for a, b in zip(got, ref))
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"{label}: {name}'s first chunk differs from its CPU transform ({ctx_err[name]})")
    cpu_check_s = time.perf_counter() - t0

    # device ms per 64-frame chunk, the chunk resident: the composite of
    # the first stall chunk, and each transform of the first stalled chunk
    composite_ms = time_ms(lambda: comp(gathered, *masks), reps=3)
    resident = [h.to(dev) for h in stalled.kept[0]]
    transform_ms = {}
    for name, pp, p, _ in contexts:
        tf = cp.make_cpvs_transform(p, pp, pix_fmt, False)
        transform_ms[name] = time_ms(lambda: tf(resident), reps=3)
    if preview:
        tf = cp.make_preview_transform(pix_fmt)
        transform_ms["preview"] = time_ms(lambda: tf(resident), reps=3)
    result = {
        "label": label, "pix_fmt": pix_fmt, "events": events, "skipping": skipping,
        "source_frames": frames, "stalled_frames": stalled.frames,
        "context_frames": got_ctx,
        "fused_seconds": seconds, "fused_frames_per_s": stalled.frames / seconds,
        "staged_seconds": staged_s, "staged_frames_per_s": staged.frames / staged_s,
        "composite_ms_per_chunk": composite_ms, "transform_ms_per_chunk": transform_ms,
        "peak_device_bytes": peak, "launches": launches, "staged_launches": staged_launches,
        "checksum": f"{stalled.checksum:016x}", "first_stall_chunk": first_stall,
        "context_first_chunk_max_err": ctx_err, "cpu_check_s": cpu_check_s,
        "sink_fetch_s": {k: v.fetch_s for k, v in [("stalled", stalled), *sinks.items()]},
        "sink_checksum_s": {k: v.checksum_s for k, v in [("stalled", stalled), *sinks.items()]},
    }
    log(f"downstream {label}: fused {result['fused_frames_per_s']:.2f} frames/s end to end "
        f"(pump_ready, composite, {len(pipes)} pipelines, {len(sinks) + 1} sinks), staged "
        f"{result['staged_frames_per_s']:.2f} frames/s (gather, composite, one sink); device "
        f"ms per {chunk}-frame chunk: composite {composite_ms:.3f}, transforms "
        f"{json.dumps(transform_ms)}; peak device bytes {peak}; CPU checks {cpu_check_s:.1f} s")
    del tee, gathered, resident, fan, pipes
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 8: timing beside the bounds
# ---------------------------------------------------------------------------


def bound(bytes_moved: float, *work: tuple[float, float]) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the sum over `work`'s (operations, operations/s)."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = sum(ops / rate for ops, rate in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(dev) -> dict:
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t = avpvs.CHUNK
    out = {}

    def resize_row(planes, dims, method, per):
        """One row: the plane calls of one chunk through each route. The
        bound is the larger of the bytes (each input read once, each
        output written once) and the int32 multiply-adds of both passes
        (kh taps for each source row of each output column, kv for each
        output sample); both are kept."""
        floats = [p.to(torch.float32)[:, None] for p in planes]
        bytes_moved = ops = 0
        for p, (dh, dw) in zip(planes, dims):
            _, h, w = p.shape
            plan = ck._resize_plan(h, w, dh, dw, method, True, 1)
            bytes_moved += t * (h * w + dh * dw)
            ops += 2 * t * (h * dw * plan["kh"] + dh * dw * plan["kv"])
        row = dict(
            zip(("bound_ms", "bound_by"), bound(bytes_moved, (ops, INT32_OPS_S))),
            bound_bytes_ms=bound(bytes_moved)[0],
            bound_ops_ms=bound(0, (ops, INT32_OPS_S))[0],
            ms=time_ms(lambda: [ck.resize_frames_fused(p, h, w, method)
                                for p, (h, w) in zip(planes, dims)], reps=10),
            plain_ms=time_ms(lambda: [ck.resize_frames_plain(p, h, w, method)
                                      for p, (h, w) in zip(planes, dims)], reps=2),
            # F.interpolate has no lanczos: its bicubic is the yardstick for all
            library_ms=time_ms(lambda: [F.interpolate(f, size=(h, w), mode="bicubic")
                                        for f, (h, w) in zip(floats, dims)], reps=3),
            library_call="torch.nn.functional.interpolate(bicubic, f32) per plane",
            per=per,
        )
        # for information: the antialiased call, which filters a downscale
        # as the swscale plans do (not the yardstick: it may be refused)
        try:
            row["library_antialias_ms"] = time_ms(
                lambda: [F.interpolate(f, size=(h, w), mode="bicubic", antialias=True)
                         for f, (h, w) in zip(floats, dims)], reps=3)
        except (RuntimeError, NotImplementedError) as exc:
            row["library_antialias_ms"] = None
            row["library_antialias_refused"] = f"{type(exc).__name__}: {exc}"[:300]
        del floats
        torch.cuda.empty_cache()
        return row

    # resize: the three plane calls of one 64-frame chunk, bicubic (the
    # seam's and the waves' method) and lanczos (the flagship step's), and
    # the mobile CPVS downscale of one 2160p chunk (phase 7)
    planes = [random_frames(gen, s, 255, torch.uint8, dev) for s in plane_shapes(t)]
    dims = [(DST_H, DST_W), (DST_H // 2, DST_W // 2), (DST_H // 2, DST_W // 2)]
    rows = {method: resize_row(planes, dims, method,
                               "one 64-frame yuv420p chunk: Y 1080x1920->2160x3840, U and V "
                               f"540x960->1080x1920, u8 {method}")
            for method in ("bicubic", "lanczos")}
    planes = [random_frames(gen, (t, h, w), 255, torch.uint8, dev) for h, w in dims]
    rows["cpvs_downscale"] = resize_row(
        planes, [(MOBILE_H, MOBILE_W), (MOBILE_H // 2, MOBILE_W // 2),
                 (MOBILE_H // 2, MOBILE_W // 2)], "bicubic",
        "one 64-frame 2160p yuv420p chunk to the mobile CPVS: Y 2160x3840->1080x1920, "
        "U and V 1080x1920->540x960, u8 bicubic")
    # p01's quality ladder: the same 2160p chunk to 640x360 and 320x180
    for h, w in LADDER[1:]:
        rows[f"ladder_{w}x{h}"] = resize_row(
            planes, [(h, w), (h // 2, w // 2), (h // 2, w // 2)], "bicubic",
            f"one 64-frame 2160p yuv420p chunk to the {w}x{h} quality level: Y "
            f"2160x3840->{h}x{w}, U and V 1080x1920->{h // 2}x{w // 2}, u8 bicubic")
    out["resize_frames_fused"] = dict(rows["bicubic"], **{
        k: v for k, v in rows.items() if k != "bicubic"})
    del planes
    torch.cuda.empty_cache()

    # SI and TI: one 64-frame 2160x3840 u8 luma chunk, TI with a predecessor
    y = random_frames(gen, (t, DST_H, DST_W), 255, torch.uint8, dev)
    prev = random_frames(gen, (DST_H, DST_W), 255, torch.uint8, dev)
    hw = DST_H * DST_W
    sobel = torch.tensor([[[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                          [[-1., -2., -1.], [0., 0., 0.], [1., 2., 1.]]],
                         device=dev)[:, None]
    interior = t * (DST_H - 2) * (DST_W - 2)
    # SI: the u8 chunk, and the 10-bit seam's chunk (10-bit values in u16)
    y16 = random_frames(gen, (t, DST_H, DST_W), 1023, torch.uint16, dev)
    si_rows = {}
    for key, frames in (("u8", y), ("u16", y16)):
        yf = frames.to(torch.float32)[:, None]
        si_rows[key] = dict(
            zip(("bound_ms", "bound_by"), bound(
                t * hw * frames.element_size(), (SI_OPS_PER_PX * interior, FP32_OPS_S))),
            ms=time_ms(lambda: ck.si_frames_fused(frames), reps=10),
            plain_ms=time_ms(lambda: ck.si_frames_plain(frames), reps=2),
            library_ms=time_ms(lambda: F.conv2d(yf, sobel), reps=3),
            library_call="torch.nn.functional.conv2d(f32, 2 Sobel filters): gradients only",
            per=f"one 64-frame 2160x3840 {'u8' if key == 'u8' else '10-bit u16'} luma chunk",
        )
        del yf
    out["si_frames_fused"] = dict(si_rows["u8"], u16=si_rows["u16"])
    del y16
    out["ti_frames_fused"] = dict(
        zip(("bound_ms", "bound_by"), bound((t + 1) * hw, (TI_OPS_PER_PX * t * hw, INT32_OPS_S))),
        ms=time_ms(lambda: ck.ti_frames_fused(y, prev), reps=10),
        plain_ms=time_ms(lambda: ck.ti_frames_plain(y, prev), reps=2),
        library_ms=None,
        library_call=None,
        per="one 64-frame 2160x3840 u8 luma chunk with a predecessor frame",
    )
    # the fused SI+TI kernels on the same chunk; the yardstick is the same
    # F.conv2d call as SI's, and the separate SI + TI kernels are timed
    # beside them in the same run
    conv = dict(library_ms=out["si_frames_fused"]["library_ms"],
                library_call=out["si_frames_fused"]["library_call"])
    yb, prevb = y[None], prev[None]
    out["siti_frames_fused_batch"] = dict(
        zip(("bound_ms", "bound_by"), bound(
            (t + 1) * hw, (SI_OPS_PER_PX * interior, FP32_OPS_S),
            (TI_OPS_PER_PX * t * hw, INT32_OPS_S))),
        ms=time_ms(lambda: ck.siti_frames_fused_batch(yb, prevb), reps=10),
        plain_ms=time_ms(lambda: ck.siti_frames_batch_plain(yb, prevb), reps=1),
        separate_ms=time_ms(lambda: (ck.si_frames_fused(y), ck.ti_frames_fused(y, prev)), reps=10),
        per="one [1, 64, 2160, 3840] u8 luma chunk with its predecessor frame",
        **conv,
    )
    out["siti_frames_fused"] = dict(
        zip(("bound_ms", "bound_by"), bound(
            t * hw, (SI_OPS_PER_PX * interior, FP32_OPS_S),
            (TI_OPS_PER_PX * (t - 1) * hw, INT32_OPS_S))),
        ms=time_ms(lambda: ck.siti_frames_fused(y), reps=10),
        plain_ms=time_ms(lambda: ck.siti_frames_plain(y), reps=1),
        separate_ms=time_ms(lambda: (ck.si_frames_fused(y), ck.ti_frames_fused(y)), reps=10),
        per="one 64-frame 2160x3840 u8 luma chunk, TI[0] = 0",
        **conv,
    )
    for name, r in list(out.items()) + [
            (f"resize_frames_fused {k}", out["resize_frames_fused"][k])
            for k in ("lanczos", "cpvs_downscale", "ladder_640x360", "ladder_320x180")] + [
            ("si_frames_fused u16", out["si_frames_fused"]["u16"])]:
        sep = f", separate SI + TI kernels {r['separate_ms']:.4f} ms" if "separate_ms" in r else ""
        prev_design = (f", previous design {PREVIOUS[name]['previous_ms']} ms "
                       f"({PREVIOUS[name]['previous_from']})" if name in PREVIOUS else "")
        both = (f"; bytes {r['bound_bytes_ms']:.4f} ms, operations {r['bound_ops_ms']:.4f} ms"
                if "bound_ops_ms" in r else "")
        aa = (f", antialiased library {r['library_antialias_ms']} ms"
              f"{' (' + r['library_antialias_refused'] + ')' if 'library_antialias_refused' in r else ''}"
              if "library_antialias_ms" in r else "")
        log(f"timing {name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}{both}), plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']} ms{aa}{sep}{prev_design} — {r['per']}")
    return out


# ---------------------------------------------------------------------------
# phase 9: p01's quality ladder
# ---------------------------------------------------------------------------

SRC_FPS = 60.0
SEGMENT_FRAMES, SEGMENT_FRAMES_10BIT = 240, 128  # a 4 s event; 2 chunks
UHD_H, UHD_W = 2160, 3840
# (label, source, level width, fps spec, target pix_fmt): the sources are
# (a) the 2160p u8 segment, (b) the first 240 frames of phase 4's 1080p
# clip, (c) the 2160p 10-bit segment
LADDER_RUNS = (
    ("2160p_1920x1080_30", "2160p", 1920, 30, "yuv420p"),
    ("2160p_1280x720_30", "2160p", 1280, 30, "yuv420p"),
    ("2160p_640x360_24", "2160p", 640, 24, "yuv420p"),
    ("2160p_320x180_15", "2160p", 320, 15, "yuv420p"),
    ("1080p_1280x720_30", "1080p", 1280, 30, "yuv420p"),
    ("1080p_640x360_24", "1080p", 640, 24, "yuv420p"),
    ("2160p10_1920x1080_30", "2160p10", 1920, 30, "yuv420p10le"),
)
CPU_CHECK_FRAMES = 2  # frames each CPU re-check of phases 9-10 recomputes


def ladder_sources() -> dict:
    """The host chunks of phase 9's three sources: (chunks, height, width)."""
    return {
        "2160p": (synthetic_clip(SEGMENT_FRAMES, avpvs.CHUNK, False, SEED + 9, UHD_H, UHD_W),
                  UHD_H, UHD_W),
        # phase 4's clip has the same first frames whatever its length
        "1080p": (synthetic_clip(SEGMENT_FRAMES, avpvs.CHUNK, False, SEED + CLIP_FRAMES),
                  SRC_H, SRC_W),
        "2160p10": (synthetic_clip(SEGMENT_FRAMES_10BIT, avpvs.CHUNK, True, SEED + 10,
                                   UHD_H, UHD_W), UHD_H, UHD_W),
    }


def ladder_segment(src_h: int, src_w: int, width: int, fps_spec) -> SimpleNamespace:
    """What `plan_segment_frames` reads of a `Segment`: its SRC's geometry
    and rate, its quality level's width and fps spec (phase 14 plans from
    the real objects of a database)."""
    src = SimpleNamespace(stream_info={"height": src_h, "width": src_w},
                          get_fps=lambda: SRC_FPS)
    return SimpleNamespace(src=src, quality_level=SimpleNamespace(width=width, fps=fps_spec))


def run_ladder(dev, label: str, chunks, src_h: int, src_w: int, width: int, fps_spec,
               pix_fmt: str) -> dict:
    th, tw, target_fps, out_fps = segments.plan_segment_frames(
        ladder_segment(src_h, src_w, width, fps_spec))
    n_src = sum(c[0].shape[0] for c in chunks)
    state = {"checksum": 0, "frames": 0, "chunks": 0, "first": None}

    def encode_stand_in():
        for planes in segments.scaled_chunks(iter(chunks), SRC_FPS, target_fps, th, tw,
                                             pix_fmt, device=dev):
            state["checksum"] = fold_checksum(state["checksum"], planes)
            state["frames"] += planes[0].shape[0]
            state["chunks"] += 1
            if state["first"] is None:
                state["first"] = planes

    _, launches, seconds = counted(encode_stand_in)
    want_frames = len(fps_ops.select_indices(n_src, SRC_FPS, target_fps or SRC_FPS))
    log(f"p01 ladder {label}: {n_src} source frames -> {state['frames']} frames of "
        f"{tw}x{th} at {out_fps} fps in {state['chunks']} chunks, {seconds:.3f} s, "
        f"launches {launches}")
    require(state["frames"] == want_frames,
            f"ladder {label}: {state['frames']} frames kept, select_indices says {want_frames}")
    want = launches_want(resize_frames_fused=3 * state["chunks"])
    require(launches == want, f"ladder {label}: launches {launches} != {want}")

    # the first selected chunk through the plain resize on the card, and
    # its first frames through the same entry point on the CPU
    sel = next(fps_ops.stream_select(iter(chunks[:1]), SRC_FPS, target_fps)) \
        if target_fps not in (None, SRC_FPS) else chunks[0]
    sub = fr.chroma_subsampling(pix_fmt)
    ten_bit = "10" in pix_fmt
    dims = [(th, tw), (th // sub[0], tw // sub[1]), (th // sub[0], tw // sub[1])]
    first_dev = [torch.from_numpy(p).to(dev) for p in sel]
    plain = fr.to_uint8([ck.resize_frames_plain(p, h, w, "bicubic")
                         for p, (h, w) in zip(first_dev, dims)], ten_bit)
    require(all(np.array_equal(a, b) for a, b in zip(state["first"], plain)),
            f"ladder {label}: the first chunk differs from the plain resize")
    cpu = next(segments.scaled_chunks(iter([[p[:CPU_CHECK_FRAMES] for p in sel]]), SRC_FPS,
                                      None, th, tw, pix_fmt, device="cpu"))
    require(all(np.array_equal(a[:CPU_CHECK_FRAMES], b) for a, b in zip(state["first"], cpu)),
            f"ladder {label}: the first frames differ from the CPU route")
    routes = []
    for p, (h, w) in zip(first_dev, dims):
        exact = ck._exact_route(p.dtype, p.shape[1], p.shape[2], h, w, "bicubic")
        plan = ck._resize_plan(p.shape[1], p.shape[2], h, w, "bicubic", exact, p.element_size())
        routes.append(f"{p.shape[1]}x{p.shape[2]}->{h}x{w} "
                      f"{'resize_ring' if plan['ring'] else 'resize_stream'} "
                      f"(kh {plan['kh']}, kv {plan['kv']})")
    def scale():
        return fr.scale_yuv_frames(first_dev, th, tw, "bicubic", sub)

    device_ms = time_ms(scale, reps=5)
    queued_ms, enqueue_ms = time_ms_queued(scale, reps=5)
    result = {
        "label": label, "pix_fmt": pix_fmt, "source": f"{src_w}x{src_h}@{SRC_FPS:g}",
        "level": f"{tw}x{th}@{out_fps:g}", "source_frames": n_src,
        "frames": state["frames"], "chunks": state["chunks"], "seconds": seconds,
        "source_frames_per_s": n_src / seconds, "launches": launches, "routes": routes,
        "device_ms_per_chunk": device_ms, "device_ms_queued_ahead": queued_ms,
        "host_enqueue_ms": enqueue_ms, "frames_per_device_chunk": sel[0].shape[0],
        "checksum": f"{state['checksum']:016x}",
    }
    log(f"p01 ladder {label}: {result['source_frames_per_s']:.2f} source frames/s end to "
        f"end, device {device_ms:.4f} ms per {avpvs.CHUNK}-frame source chunk "
        f"({sel[0].shape[0]} frames scaled; {queued_ms:.4f} ms with the calls queued ahead, "
        f"host enqueue {enqueue_ms:.4f} ms); routes {routes}; first chunk equal to plain, "
        f"first {CPU_CHECK_FRAMES} frames equal to the CPU route")
    del first_dev, plain, state
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 10: the quality tools
# ---------------------------------------------------------------------------

# tier-1's tolerances for the quality table (tests/test_torch_quality.py)
TABLE_ATOL = {"psnr_y": 1e-3, "psnr_u": 1e-3, "psnr_v": 1e-3, "ssim_y": 1e-4,
              "msssim_y": 1e-4, "vif_y": 1e-4, "si": 1e-3, "ti": 1e-3}


def table_max_err(got: dict, want: dict, rows: int) -> dict:
    return {k: float(np.abs(np.asarray(got[k][:rows], np.float64)
                            - np.asarray(want[k][:rows], np.float64)).max())
            for k in list(want)[1:]}


def run_quality(dev, label: str, frames: int, pix_fmt: str) -> dict:
    ten_bit = "10" in pix_fmt
    scale = 0.25 if ten_bit else 1.0
    src = synthetic_clip(frames, avpvs.CHUNK, ten_bit, SEED + frames)  # phase 4's clip
    keeper = KeepSink()
    feat = avpvs.SiTiAccumulator()
    avpvs.pump_ready(iter(src), keeper, feat, DST_H, DST_W, pix_fmt, device=dev)
    deg_chunks = [[p[lo:lo + qm.CHUNK] for p in c] for c in keeper.chunks
                  for lo in range(0, c[0].shape[0], qm.CHUNK)]
    n_chunks = len(deg_chunks)
    out_index = qm._src_index_map(CANVAS_FPS, CANVAS_FPS)

    def score():
        ref_frames = pfe.iter_chunk_frames([[torch.from_numpy(p) for p in c] for c in src])
        pairs = qm._paired_chunks(iter(deg_chunks), ref_frames, out_index, qm.CHUNK)
        with pfe.Prefetcher(pairs, depth=2) as pre:
            return qm.score_chunks(pre, msssim=True, vif=True, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    table, launches, seconds = counted(score)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"quality {label}: {frames} AVPVS frames in {n_chunks} chunks of {qm.CHUNK}, "
        f"{seconds:.3f} s, launches {launches}")
    require(list(table) == ["frame"] + qm.metric_columns(True, True)
            and all(len(v) == frames for v in table.values()),
            f"quality {label}: table columns {list(table)} / rows")
    require(all(np.isfinite(np.asarray(v, np.float64)).all() for v in table.values()),
            f"quality {label}: non-finite values")
    want = launches_want(si_frames_fused=n_chunks, ti_frames_fused=n_chunks)
    require(launches == want, f"quality {label}: launches {launches} != {want}")
    acc_si = torch.cat(feat.si).cpu().numpy() * scale
    acc_ti = torch.cat(feat.ti).cpu().numpy() * scale
    siti_err = max(float(np.abs(table["si"] - acc_si).max()),
                   float(np.abs(table["ti"] - acc_ti).max()))
    require(siti_err <= 1e-3, f"quality {label}: SI/TI off pump_ready's accumulator by {siti_err}")

    # the first frames again through the CPU route, banded forced
    n = CPU_CHECK_FRAMES
    t0 = time.perf_counter()
    cpu = qm.score_chunks(iter([([p[:n].cpu() for p in deg_chunks[0]],
                                 [torch.from_numpy(p[:n]) for p in src[0]])]),
                          msssim=True, vif=True, device="cpu", resize_method="banded")
    cpu_s = time.perf_counter() - t0
    cpu_err = table_max_err(table, cpu, n)
    require(all(cpu_err[k] <= TABLE_ATOL[k] for k in cpu_err),
            f"quality {label}: the first {n} rows differ from the CPU route: {cpu_err}")
    # an identity pair: the first AVPVS chunk against itself
    ident = qm.score_chunks(iter([(deg_chunks[0], deg_chunks[0])]), msssim=True, vif=True,
                            device=dev)
    require(bool((ident["psnr_y"] == 100.0).all() and (ident["psnr_u"] == 100.0).all()),
            f"quality {label}: identity PSNR {ident['psnr_y'][:4]}")
    ident_min = {k: float(ident[k].min()) for k in ("ssim_y", "msssim_y", "vif_y")}
    require(all(v >= 0.9999 for v in ident_min.values()),
            f"quality {label}: identity pair scores {ident_min}")

    # device ms per 32-frame chunk, the pair resident on the card
    deg = deg_chunks[0]
    ref = [torch.from_numpy(p[:qm.CHUNK]).to(dev) for p in src[0]]
    dy, du, dv = (p.to(torch.float32) * scale for p in deg)

    def resize_src():
        return [resize_ops.resize_plane(r.to(torch.float32) * scale, d.shape[-2], d.shape[-1],
                                        "bicubic") for r, d in zip(ref, (dy, du, dv))]

    ry, ru, rv = resize_src()
    ms = {
        "src_resize_banded": time_ms(resize_src, reps=3),
        "psnr_yuv": time_ms(lambda: [metrics_ops.psnr_frames(r, d) for r, d in
                                     ((ry, dy), (ru, du), (rv, dv))], reps=3),
        "ssim": time_ms(lambda: metrics_ops.ssim_frames(ry, dy), reps=2),
        "msssim_with_ssim": time_ms(lambda: metrics_ops.msssim_ssim_frames(ry, dy), reps=2),
        "vif": time_ms(lambda: metrics_ops.vif_frames(ry, dy), reps=2),
        "si_ti_kernels": time_ms(lambda: (ck.si_frames_fused(deg[0]),
                                          ck.ti_frames_fused(deg[0])), reps=3),
    }
    result = {
        "label": label, "pix_fmt": pix_fmt, "frames": frames, "chunks": n_chunks,
        "seconds": seconds, "frames_per_s": frames / seconds, "launches": launches,
        "peak_device_bytes": peak, "device_ms_per_chunk": ms,
        "siti_vs_accumulator_max_err": siti_err, "cpu_rows_max_err": cpu_err,
        "cpu_check_s": cpu_s, "identity_min": ident_min,
        "means": {k: float(np.mean(table[k])) for k in list(table)[1:]},
    }
    log(f"quality {label}: {result['frames_per_s']:.2f} frames/s end to end (AVPVS chunks on "
        f"the card, SRC gathered on the host, MS-SSIM and VIF on); device ms per "
        f"{qm.CHUNK}-frame chunk {json.dumps(ms)}; peak device bytes {peak}; SI/TI vs the "
        f"accumulator {siti_err}; first {n} rows vs the CPU route {json.dumps(cpu_err)} "
        f"({cpu_s:.1f} s); identity pair {ident_min}")
    del keeper, deg_chunks, deg, ref, dy, du, dv, ry, ru, rv, feat
    torch.cuda.empty_cache()
    return result


def run_src_analysis(dev, label: str, chunks) -> dict:
    ten_bit = chunks[0][0].dtype == np.uint16
    summary, launches, seconds = counted(
        lambda: src_analysis.src_siti_summary(iter(chunks), device=dev))
    n_chunks = len(chunks)
    n_frames = sum(c[0].shape[0] for c in chunks)
    want = launches_want(si_frames_fused=n_chunks, ti_frames_fused=n_chunks)
    require(launches == want, f"src analysis {label}: launches {launches} != {want}")
    si, ti = src_analysis.src_siti_frames(iter(chunks), device=dev)
    require(summary == src_analysis.summarize_siti(si, ti),
            f"src analysis {label}: summary {summary} differs from its per-frame values")
    n = CPU_CHECK_FRAMES
    csi, cti = src_analysis.src_siti_frames(iter([[chunks[0][0][:n]]]), device="cpu")
    atol = 2.5e-3 if ten_bit else 1e-3  # the seam's 1e-2 / 1e-3 at container depth, scaled
    err = max(float(np.abs(si[:n] - csi).max()), float(np.abs(ti[:n] - cti).max()))
    require(err <= atol, f"src analysis {label}: first frames off the CPU route by {err}")
    log(f"src analysis {label}: {n_frames} frames, {seconds:.3f} s "
        f"({n_frames / seconds:.2f} frames/s), launches {launches}, summary {summary}, "
        f"first {n} frames vs the CPU route {err}")
    return {"label": label, "frames": n_frames, "seconds": seconds,
            "frames_per_s": n_frames / seconds, "launches": launches, "summary": summary,
            "cpu_max_err": err}


class SyntheticPriors:
    """A seeded MV table with the PriorsData fields that
    priors.features reads: I, P and B frames of a 16x16 block grid, one MV
    row per predicted block (a zoom-like field plus noise, a tenth of the
    blocks left intra), B frames with each block twice (one row a
    prediction direction)."""

    def __init__(self, n: int, height: int, width: int, seed: int):
        rng = np.random.default_rng(seed)
        self.height, self.width = height, width
        self.pict_type = np.array([1 if k % 12 == 0 else (3 if k % 3 == 2 else 2)
                                   for k in range(n)], np.int8)
        gy, gx = np.mgrid[0:(height + 15) // 16, 0:(width + 15) // 16]
        cx, cy = gx.ravel() * 16 + 8, gy.ravel() * 16 + 8
        rows, counts = [], []
        for k in range(n):
            if self.pict_type[k] == 1:
                counts.append(0)
                continue
            keep = rng.random(cx.size) > 0.1
            dx = np.round((cx - width / 2) * 0.01 * (k % 7) + rng.normal(0, 1.5, cx.size))
            dy = np.round((cy - height / 2) * 0.01 * (k % 7) + rng.normal(0, 1.5, cx.size))
            blk = np.stack([cx - dx, cy - dy, cx, cy, np.full_like(cx, 16),
                            np.full_like(cx, 16), np.full_like(cx, -1)], 1)[keep]
            blk = blk.astype(np.int32)
            if self.pict_type[k] == 3:
                fwd = blk.copy()
                fwd[:, 6] = 1
                blk = np.concatenate([blk, fwd])
            rows.append(blk)
            counts.append(len(blk))
        self.mv_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=self.mv_offsets[1:])
        self.mv_rows = np.concatenate(rows)

    @property
    def n_frames(self) -> int:
        return len(self.pict_type)

    @property
    def n_mvs(self) -> int:
        return int(self.mv_rows.shape[0])

    def mv_for(self, i: int) -> np.ndarray:
        return self.mv_rows[self.mv_offsets[i]:self.mv_offsets[i + 1]]

    def has_mvs(self) -> bool:
        return self.n_mvs > 0


def run_priors(dev) -> dict:
    data = SyntheticPriors(SEGMENT_FRAMES, SRC_H, SRC_W, SEED + 11)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = prior_features.temporal_features(data, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = prior_features.temporal_features(data, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in want}
    require(list(got) == list(want) and all(
        np.allclose(got[k], want[k], rtol=1e-5, atol=1e-6) for k in want),
        f"priors: card vs CPU route {err}")
    moving = data.pict_type != 1
    require(bool((got["divergence"][moving] > 0).all() and (got["mean_mag"][moving] > 0).all()),
            "priors: a predicted frame without motion features")
    mags = prior_features.mv_magnitudes(data.mv_rows, dev)
    mag_err = float((mags.cpu() - prior_features.mv_magnitudes(data.mv_rows, "cpu")).abs().max())
    require(mag_err <= 1e-4, f"priors: mv_magnitudes card vs CPU {mag_err}")
    log(f"priors: {data.n_frames} frames, {data.n_mvs} MV rows; temporal_features "
        f"{card_s:.3f} s with the card, {cpu_s:.3f} s on the CPU; max|card-CPU| {err}, "
        f"mv_magnitudes {mag_err}")
    return {"frames": data.n_frames, "mv_rows": data.n_mvs, "card_s": card_s, "cpu_s": cpu_s,
            "max_err": err, "mv_magnitudes_max_err": mag_err}


# ---------------------------------------------------------------------------
# phase 11: the serve path
# ---------------------------------------------------------------------------

SERVE_GEO = {"frames": 60, "src_h": SRC_H, "src_w": SRC_W, "dst_h": DST_H, "dst_w": DST_W}
SERVE_A = {"tenant": "lab-a", "database": "P2STR01", "srcs": ["SRC001", "SRC002"],
           "hrcs": ["HRC001", "HRC002"], "params": SERVE_GEO}
SERVE_B = {"tenant": "lab-b", "database": "P2STR01", "srcs": ["SRC002"],
           "hrcs": ["HRC002", "HRC003"], "params": SERVE_GEO}
SERVE_PLANS = 5  # A's 4 units and B's 2 share SRC002_HRC002
SERVE_BLOCK = 8  # the wave executor's chunk


def _http(url: str, payload=None, timeout: float = 120.0):
    """(status, body bytes) of one GET, or of one POST of `payload`."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _http_sha256(url: str) -> tuple:
    """(status, sha256 hex, bytes) of one streamed GET."""
    h = hashlib.sha256()
    n = 0
    with urllib.request.urlopen(url, timeout=600) as resp:
        while True:
            block = resp.read(1 << 22)
            if not block:
                break
            h.update(block)
            n += len(block)
        return resp.status, h.hexdigest(), n


def _metric_sum(name: str, labels=None) -> float:
    """Sum of a port telemetry metric's series matching `labels`."""
    return serve_tm.REGISTRY.sum_series(name, labels) or 0.0


def _wait_done(url: str, req_id: str, timeout: float) -> tuple:
    """Poll one request until it leaves `active`: (doc, client seconds)."""
    t0 = time.perf_counter()
    while True:
        code, body = _http(f"{url}/v1/requests/{req_id}")
        require(code == 200, f"serve: GET {req_id} -> {code}")
        doc = json.loads(body)
        if doc["state"] != "active":
            return doc, time.perf_counter() - t0
        require(time.perf_counter() - t0 < timeout, f"serve: {req_id} still active")
        time.sleep(0.01)


def serve_reference(dev, executor, unit, geo=SERVE_GEO) -> str:
    """sha256 of one unit's artifact by the plain route on the card: its
    seeded YUV through the plain bicubic resize (quantized to u8), Y then
    U then V, in frame order."""
    h = hashlib.sha256()
    dims = [(geo["dst_h"], geo["dst_w"]), (geo["dst_h"] // 2, geo["dst_w"] // 2),
            (geo["dst_h"] // 2, geo["dst_w"] // 2)]
    for plane, (dh, dw) in zip(executor.source_planes(unit), dims):
        out = ck.resize_frames_plain(torch.from_numpy(plane).to(dev), dh, dw, "bicubic")
        h.update(out.cpu().numpy().tobytes())
        del out
    return h.hexdigest()


def run_serve(dev, workdir: str) -> dict:
    """Phase 11: the serve path at full width (see the module doc)."""
    root = os.path.join(workdir, "serve")
    shutil.rmtree(root, ignore_errors=True)
    svc = ChainServeService(root=root, port=0, executor="wave", workers=1,
                            wave_width=4, device=dev)
    try:
        svc.start()
        result = _drive_serve(dev, svc)
        result["observed"] = observe_serve(svc, workdir)
        return result
    finally:
        svc.stop()
        meshobs.detach_journal()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _drive_serve(dev, svc) -> dict:
    url = svc.server.url
    frames = SERVE_GEO["frames"]
    planned0 = _metric_sum("chain_jobs_planned_total", {"runner": "serve"})
    waves0 = _metric_sum("chain_serve_waves_total")
    serve_tm.EVENTS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launches()
    t0 = time.perf_counter()
    code, body = _http(url + "/v1/requests", SERVE_A)
    require(code == 202, f"serve: POST A -> {code} {body[:300]!r}")
    acc_a = json.loads(body)
    # B goes in while A's wave runs: wait until one of A's units runs
    while True:
        doc = json.loads(_http(url + acc_a["url"])[1])
        if doc["state"] != "active" or any(
                u["state"] in ("running", "done") for u in doc["units"].values()):
            break
        require(time.perf_counter() - t0 < 120, "serve: A never started running")
        time.sleep(0.005)
    a_running = doc["state"] == "active"
    t_b = time.perf_counter()
    code, body = _http(url + "/v1/requests", SERVE_B)
    require(code == 202, f"serve: POST B -> {code} {body[:300]!r}")
    acc_b = json.loads(body)
    doc_a, _ = _wait_done(url, acc_a["request"], 600)
    t_a = time.perf_counter() - t0
    doc_b, _ = _wait_done(url, acc_b["request"], 600)
    t_all = time.perf_counter() - t0
    t_b = time.perf_counter() - t_b
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    require(doc_a["state"] == "done" and doc_b["state"] == "done",
            f"serve: A {doc_a['state']} {doc_a.get('error')}, B {doc_b['state']} "
            f"{doc_b.get('error')}")
    planned = int(_metric_sum("chain_jobs_planned_total", {"runner": "serve"}) - planned0)
    waves = int(_metric_sum("chain_serve_waves_total") - waves0)
    events = serve_tm.EVENTS.records()
    batches = [e["units"] for e in events if e.get("event") == "serve_wave"]
    # run_batch seconds of each unit's job (Job.run times its fn, the
    # wave's run_batch; the store commit follows it)
    job_s = sorted(e["duration_s"] for e in events
                   if e.get("event") == "job_end" and e.get("status") == "ok")
    log(f"serve: A done in {t_a:.3f} s (server {doc_a['latency_ms']} ms), B in {t_b:.3f} s "
        f"(server {doc_b['latency_ms']} ms); B posted while A ran: {a_running}, B's units "
        f"{acc_b['outcomes']}; planned {planned}, waves {waves}, batches {batches}, "
        f"launches {launches}")
    require(planned == SERVE_PLANS, f"serve: {planned} plans executed, not {SERVE_PLANS}")
    require(sum(batches) == SERVE_PLANS and len(batches) == waves,
            f"serve: batches {batches} for {waves} waves")
    blocks = SERVE_PLANS * -(-frames // SERVE_BLOCK)  # one lane a wave slot (pvs=1)
    want = launches_want(resize_frames_fused=3 * blocks, siti_frames_fused_batch=blocks)
    require(launches == want, f"serve: launches {launches} != {want}")

    # the warm re-POST: answered at submit, no new wave, no new plan
    t1 = time.perf_counter()
    code, body = _http(url + "/v1/requests", SERVE_A)
    warm_ms = (time.perf_counter() - t1) * 1e3
    acc_w = json.loads(body)
    require(code == 202 and acc_w["state"] == "done"
            and acc_w["outcomes"]["warm"] == len(doc_a["units"]),
            f"serve: warm re-POST -> {code} {acc_w}")
    require(_metric_sum("chain_serve_waves_total") - waves0 == waves
            and _metric_sum("chain_jobs_planned_total", {"runner": "serve"}) - planned0 == planned,
            "serve: the warm re-POST ran a wave")
    log(f"serve: warm re-POST of A answered in {warm_ms:.3f} ms (server "
        f"{acc_w['latency_ms']} ms)")

    # the wave journal: valid + pads == dispatched on every record
    records = [r for r in meshobs.read_journals(meshobs.mesh_dir(svc.root))
               if r.get("kind") == "wave"]
    require(len(records) == blocks, f"serve: {len(records)} wave records, not {blocks}")
    for r in records:
        require(r["valid"] + r["pad_tail"] + r["pad_exhausted"] + r["pad_mesh"]
                == r["dispatched"], f"serve: wave record {r}")
    step_s = sum(r["step_s"] for r in records)

    # every artifact, over HTTP, against the plain route on the card
    units = {}
    for doc in (doc_a, doc_b):
        for pvs, u in doc["units"].items():
            units[u["plan"]] = (pvs, u)
    require(len(units) == SERVE_PLANS, f"serve: {len(units)} distinct plans")
    size = frames * SERVE_GEO["dst_h"] * SERVE_GEO["dst_w"] * 3 // 2
    written = 0
    t_fetch = t_ref = 0.0
    seed_s = []
    for plan, (pvs, u) in sorted(units.items()):
        require(u["state"] == "done", f"serve: unit {pvs} {u['state']}")
        t2 = time.perf_counter()
        code, digest, n = _http_sha256(url + u["artifact"])
        t_fetch += time.perf_counter() - t2
        require(code == 200 and n == size, f"serve: {pvs}: GET -> {code}, {n} bytes, not {size}")
        _, src, hrc = pvs.split("_")
        unit = serve_api.Unit("P2STR01", src, hrc, dict(SERVE_GEO))
        require(svc.store.plan_hash(svc.executor.plan(unit)) == plan,
                f"serve: {pvs}: plan hash differs")
        t2 = time.perf_counter()
        svc.executor.source_planes(unit)
        seed_s.append(time.perf_counter() - t2)
        t2 = time.perf_counter()
        ref = serve_reference(dev, svc.executor, unit)
        t_ref += time.perf_counter() - t2
        require(digest == ref, f"serve: {pvs}: artifact differs from the plain route")
        written += n
    log(f"serve: {len(units)} artifacts of {size} bytes equal the plain route "
        f"(fetch {t_fetch:.2f} s, reference {t_ref:.2f} s)")

    # kernel vs plain at the serve path's wave-block shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    yb = random_frames(gen, (1, SERVE_BLOCK, DST_H, DST_W), 255, torch.uint8, dev)
    prevb = random_frames(gen, (1, DST_H, DST_W), 255, torch.uint8, dev)
    got = ck.siti_frames_fused_batch(yb, prevb)
    want_siti = ck.siti_frames_batch_plain(yb, prevb)
    siti_err = max(max_abs(a, b) for a, b in zip(got, want_siti))
    require(all(torch.allclose(a, b, rtol=1e-4, atol=1e-3) for a, b in zip(got, want_siti)),
            f"serve: siti_frames_fused_batch [1,8] off plain by {siti_err}")
    # device ms of one wave block: the wave step on [1, 8] planes, queued
    step = p03_batch._wave_step(DST_H, DST_W, "bicubic", 2, 2, False)
    lay = pmesh.BlockLayout(pmesh.make_mesh([dev]), 1, SERVE_BLOCK)
    planes = [lay.split(random_frames(gen, (1, SERVE_BLOCK) + s[1:], 255, torch.uint8, dev))
              for s in plane_shapes(SERVE_BLOCK)]
    block_ms, block_host_ms = time_ms_queued(lambda: step(lay, planes, [prevb[0]], False),
                                             reps=20)
    del yb, prevb, got, want_siti, planes
    ck.reset_launches()

    rendered = SERVE_PLANS * frames
    result = {
        "cold_a_s": t_a, "cold_b_s": t_b, "cold_both_s": t_all,
        "server_latency_ms": {"a": doc_a["latency_ms"], "b": doc_b["latency_ms"],
                              "warm": acc_w["latency_ms"]},
        "warm_ms": warm_ms, "b_posted_while_a_ran": a_running,
        "b_outcomes": acc_b["outcomes"],
        "served_frames_per_s": rendered / t_all,
        "requested_frames_per_s": (len(doc_a["units"]) + len(doc_b["units"])) * frames / t_all,
        "plans_executed": planned, "waves": waves, "lanes_per_batch": batches,
        "launches": launches, "wave_blocks": blocks, "step_s_sum": step_s,
        "job_run_batch_s": job_s, "seed_s_per_unit": seed_s,
        "device_ms_per_block": block_ms, "host_enqueue_ms_per_block": block_host_ms,
        # an estimate, not a reading of the window: wave blocks times the
        # event-timed device ms of one block (timed after the window)
        "device_busy_share_est": blocks * block_ms / 1e3 / t_all,
        "peak_device_bytes": peak, "bytes_written": written,
        "siti_batch_max_err": siti_err,
    }
    log(f"serve: {result['served_frames_per_s']:.2f} rendered frames/s "
        f"({rendered} frames in {t_all:.3f} s; {result['requested_frames_per_s']:.2f} "
        f"requested frames/s), device {block_ms:.4f} ms per {SERVE_BLOCK}-frame block "
        f"(card busy ~{100 * result['device_busy_share_est']:.2f}% est. from blocks x block ms), "
        f"peak {peak} B, "
        f"{written} bytes written")
    log(f"serve: where the time goes: run_batch per job {job_s} s (waves of "
        f"{batches} units; seeding a unit's YUV {min(seed_s):.3f}-{max(seed_s):.3f} s, "
        f"wave steps {step_s:.3f} s in all), the rest of {t_all:.3f} s is store "
        f"commits (sha256 of each artifact), HTTP and queue settles")
    return result


def observe_serve(svc, workdir: str) -> dict:
    """Phase 13 (d), on phase 11's service before it stops: /status's
    resources, counters and serve.stalls; a watchdog over a held heartbeat;
    the status-file writer `tools chain-serve --status-file` runs."""
    url = svc.server.url
    code, body = _http(url + "/status")
    require(code == 200, f"status: GET /status -> {code}")
    doc = json.loads(body)
    mem = doc.get("resources", {}).get("device_memory_by_device", {}).get("cuda:0")
    require(mem is not None and mem["bytes_in_use"] > 0 and mem["bytes_limit"] > 0,
            f"status: resources.device_memory_by_device {doc.get('resources')}")
    require(set(doc.get("counters", {})) == {"frames_decoded", "frames_encoded", "bytes_encoded"},
            f"status: counters {doc.get('counters')}")
    require(doc.get("serve", {}).get("stalls") == [], f"status: serve.stalls {doc.get('serve')}")

    status_path = os.path.join(workdir, "status.json")
    writer = serve_live.StatusFileWriter(status_path, interval_s=0.25).start()
    hb = serve_tm.HEARTBEATS.register("smoke-held", kind="task")
    dog = watchdog.Watchdog(soft_s=0.5, poll_s=0.1).start()
    try:
        t0 = time.perf_counter()
        stalls = []
        while time.perf_counter() - t0 < 2.0 and "smoke-held" not in stalls:
            time.sleep(0.05)
            stalls = [s["task"] for s in watchdog.active_stalls()]
        flagged_s = time.perf_counter() - t0
        require("smoke-held" in stalls, f"watchdog: held heartbeat not flagged in 2 s: {stalls}")
        served = json.loads(_http(url + "/status")[1])["serve"]["stalls"]
        require("smoke-held" in [s["task"] for s in served], f"status: stalls {served}")
        hb.beat()
        require("smoke-held" not in [s["task"] for s in watchdog.active_stalls()],
                "watchdog: the stall outlived a beat")
        cleared = json.loads(_http(url + "/status")[1])["serve"]["stalls"]
        require("smoke-held" not in [s["task"] for s in cleared],
                f"status: stalls after the beat {cleared}")
        stamps = set()
        t1 = time.perf_counter()
        while len(stamps) < 3 and time.perf_counter() - t1 < 5.0:
            with open(status_path) as f:
                stamps.add(json.load(f)["generated_at"])
            time.sleep(0.1)
    finally:
        dog.stop()
        hb.finish("ok")
        writer.stop()
    require(len(stamps) >= 2, f"status file rewritten {len(stamps)} time(s) in 5 s")
    with open(status_path) as f:
        final = json.load(f)
    require(final["serve"]["stalls"] == [] and "cuda:0" in final["resources"].get(
        "device_memory_by_device", {}), "status file: serve.stalls or cuda:0 memory missing")
    os.unlink(status_path)
    result = {"cuda0_memory": mem, "stall_flagged_s": flagged_s,
              "status_file_versions": len(stamps)}
    log(f"phase 13 (d): /status resources cuda:0 {mem}, counters {doc['counters']}, "
        f"serve.stalls []; a held heartbeat flagged after {flagged_s:.2f} s (soft 0.5 s) "
        f"and cleared on a beat; status file rewritten {len(stamps)} times")
    return result


# ---------------------------------------------------------------------------
# phase 12: the (pvs, time) mesh
# ---------------------------------------------------------------------------

MESH_LANES = (600, 250, 200, 130)
MESH_STEP_LANES, MESH_STEP_FRAMES = 2, 64
PLANE_DIMS = ((DST_H, DST_W), (DST_H // 2, DST_W // 2), (DST_H // 2, DST_W // 2))


class PlainCheckedSink:
    """A lane's emit end in phase 12: every emitted block goes back to the
    card and must equal the plain resize of its source chunk (blocks and
    the clip's chunks are both 64 frames from the lane's start); frames
    and features are kept. The plain SI/TI of the lane, chained across its
    chunks, is computed on the first run and kept in `plain_feats`."""

    def __init__(self, dev, clip, plain_feats: dict, key) -> None:
        self.dev, self.clip = dev, clip
        self.plain_feats, self.key = plain_feats, key
        self.frames = 0
        self.si, self.ti = [], []
        self._plain = [] if key not in plain_feats else None
        self._prev = None

    def emit(self, planes) -> None:
        k = self.frames // avpvs.CHUNK
        n = planes[0].shape[0]
        for got, src, (h, w) in zip(planes, self.clip[k], PLANE_DIMS):
            want = ck.resize_frames_plain(torch.from_numpy(src).to(self.dev), h, w, "bicubic")
            require(n == want.shape[0] and torch.equal(torch.from_numpy(got).to(self.dev), want),
                    f"mesh {self.key}: block {k} differs from the plain resize")
            if self._plain is not None and h == DST_H:
                if self._prev is None:
                    si, ti = ck.siti_frames_plain(want)
                else:
                    si, ti = (f[0] for f in ck.siti_frames_batch_plain(want[None], self._prev[None]))
                self._plain.append((si.cpu().numpy(), ti.cpu().numpy()))
                self._prev = want[-1].clone()
            del want
        self.frames += n

    def features(self, si, ti) -> None:
        self.si.append(np.asarray(si).copy())
        self.ti.append(np.asarray(ti).copy())

    def finish(self) -> tuple:
        if self._plain is not None:
            self.plain_feats[self.key] = tuple(
                np.concatenate([p[i] for p in self._plain]) for i in range(2))
        return np.concatenate(self.si), np.concatenate(self.ti)


class CountSink:
    def __init__(self) -> None:
        self.frames = 0

    def emit(self, planes) -> None:
        self.frames += planes[0].shape[0]


def mesh_wave(dev, mesh, clips, sinks, label: str, workdir: str) -> dict:
    """run_bucket over `mesh` with the journal attached: launches, seconds,
    the journal's records."""
    lanes = [p03_batch.Lane(chunks=iter(c), emit=s.emit, n_frames_hint=n,
                            emit_features=getattr(s, "features", None), name=f"{label}{i}")
             for i, (c, s, n) in enumerate(zip(clips, sinks, MESH_LANES))]
    journal = os.path.join(workdir, f"meshobs_{label}")
    shutil.rmtree(journal, ignore_errors=True)
    meshobs.attach_journal(journal)
    bucket = p03_batch.bucket_label(DST_H, DST_W, False, SRC_H, SRC_W)
    try:
        _, launches, seconds = counted(lambda: p03_batch.run_bucket(
            lanes, mesh, DST_H, DST_W, "bicubic", (2, 2), False, chunk=avpvs.CHUNK,
            bucket=bucket))
    finally:
        meshobs.detach_journal()
    records = [r for r in meshobs.read_journals(journal) if r.get("kind") == "wave"]
    shutil.rmtree(journal, ignore_errors=True)
    return {"launches": launches, "seconds": seconds, "records": records}


def wave_blocks(n_pvs: int) -> int:
    order = sorted(MESH_LANES, reverse=True)
    return sum(-(-max(order[w:w + n_pvs]) // avpvs.CHUNK) for w in range(0, len(order), n_pvs))


def run_mesh_waves(dev, devices, label: str, workdir: str) -> dict:
    """Phase 12 (a), or (d) on distinct cards: the lanes on a (pvs=2,
    time=2) mesh of `devices`, against the plain route and against a
    pvs-only mesh of the same slots; then an unchecked run for frames/s and
    the wave step's device ms a block."""
    clips = [synthetic_clip(n, avpvs.CHUNK, False, SEED + 77 * i + n)
             for i, n in enumerate(MESH_LANES)]
    frames = sum(MESH_LANES)
    plain_feats: dict = {}
    feats = {}
    runs = {}
    for tag, tp in (("2x2", 2), ("4x1", 1)):
        mesh = pmesh.make_mesh(devices, time_parallel=tp)
        sinks = [PlainCheckedSink(dev, c, plain_feats, i) for i, c in enumerate(clips)]
        run = mesh_wave(dev, mesh, clips, sinks, f"{label}_{tag}", workdir)
        n_pvs = mesh.shape["pvs"]
        blocks = wave_blocks(n_pvs)
        n_dev = len(set(devices))
        log(f"mesh {label} {tag}: {frames} frames in {run['seconds']:.3f} s (checked), "
            f"launches {run['launches']}, {len(run['records'])} wave records")
        for i, (sink, n) in enumerate(zip(sinks, MESH_LANES)):
            require(sink.frames == n, f"mesh {label} {tag} lane {i}: {sink.frames} frames")
            feats[(tag, i)] = sink.finish()
        if n_dev == 1:
            want = launches_want(resize_frames_fused=3 * blocks, siti_frames_fused_batch=blocks)
            require(run["launches"] == want, f"mesh {label} {tag}: launches {run['launches']} != {want}")
        else:
            require(run["launches"]["siti_frames_fused_batch"] == blocks * n_dev
                    and run["launches"]["resize_frames_fused"] == 3 * blocks * n_dev,
                    f"mesh {label} {tag}: launches {run['launches']}")
        require(len(run["records"]) == blocks
                and all(r["valid"] + r["pad_tail"] + r["pad_exhausted"] + r["pad_mesh"]
                        == r["dispatched"] and r["mesh"] == mesh_label(mesh)
                        for r in run["records"]),
                f"mesh {label} {tag}: journal records {run['records'][:2]}")
        runs[tag] = {"launches": run["launches"], "blocks": blocks,
                     "checked_seconds": run["seconds"],
                     "slots": {k: sum(r[k] for r in run["records"])
                               for k in ("valid", "pad_tail", "pad_exhausted", "pad_mesh",
                                         "dispatched")}}
    err = {"plain": 0.0, "4x1": 0.0}
    for i in range(len(MESH_LANES)):
        si, ti = feats[("2x2", i)]
        for ref_name, (rsi, rti) in (("plain", plain_feats[i]), ("4x1", feats[("4x1", i)])):
            e = max(float(np.abs(si - rsi).max()), float(np.abs(ti - rti).max()))
            err[ref_name] = max(err[ref_name], e)
            require(np.allclose(si, rsi, rtol=1e-4, atol=1e-3)
                    and np.allclose(ti, rti, rtol=1e-4, atol=1e-3),
                    f"mesh {label} lane {i}: SI/TI off the {ref_name} reference by {e}")
        require(ti[0] == 0.0, f"mesh {label} lane {i}: TI[0] = {ti[0]}")
    # unchecked runs: frames/s end to end, copies included
    for tag, tp in (("2x2", 2), ("4x1", 1)):
        mesh = pmesh.make_mesh(devices, time_parallel=tp)
        run = mesh_wave(dev, mesh, clips, [CountSink() for _ in clips], f"{label}_{tag}_t",
                        workdir)
        runs[tag]["seconds"] = run["seconds"]
        runs[tag]["frames_per_s"] = frames / run["seconds"]
        runs[tag]["step_s_sum"] = sum(r["step_s"] for r in run["records"])
        # the wave step on one resident block of this mesh, calls queued
        n_pvs = mesh.shape["pvs"]
        lay = pmesh.BlockLayout(mesh, n_pvs, avpvs.CHUNK)
        step = p03_batch._wave_step(DST_H, DST_W, "bicubic", 2, 2, False)
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        planes = [lay.split(random_frames(gen, (n_pvs, avpvs.CHUNK) + sh[1:], 255,
                                          torch.uint8, dev))
                  for sh in plane_shapes(avpvs.CHUNK)]
        carry = [random_frames(gen, (DST_H, DST_W), 255, torch.uint8, dev)
                 for _ in range(n_pvs)]
        ms, host_ms = time_ms_queued(lambda: step(lay, planes, carry, False), reps=3)
        runs[tag]["device_ms_per_block"] = ms
        runs[tag]["host_enqueue_ms_per_block"] = host_ms
        runs[tag]["frames_per_block"] = n_pvs * avpvs.CHUNK
        log(f"mesh {label} {tag}: {runs[tag]['frames_per_s']:.2f} frames/s end to end, "
            f"device {ms:.4f} ms per {n_pvs}x{avpvs.CHUNK}-frame block "
            f"({ms / (n_pvs * avpvs.CHUNK):.5f} ms a frame), slots {runs[tag]['slots']}")
        del planes, carry
    del clips
    torch.cuda.empty_cache()
    return {"label": label, "devices": [str(d) for d in devices], "lanes": list(MESH_LANES),
            "frames": frames, "runs": runs, "siti_max_err": err}


def mesh_label(mesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())


def run_mesh_step(dev, mesh) -> dict:
    """Phase 12 (b): make_sharded_step over the 2x2 mesh against
    avpvs_siti_step lane by lane, prev_last chained across the halves."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, t = MESH_STEP_LANES, MESH_STEP_FRAMES
    planes = [random_frames(gen, (b, t) + s[1:], 255, torch.uint8, dev) for s in plane_shapes(t)]
    step = pipeline.make_sharded_step(mesh, DST_H, DST_W, "lanczos")
    out, launches, _ = counted(lambda: step(*planes))
    want = launches_want(resize_frames_fused=3, siti_frames_fused_batch=1)
    require(launches == want, f"sharded step: launches {launches} != {want}")
    half = t // mesh.shape["time"]
    err = 0.0
    for lane in range(b):
        prev = None
        for lo in range(0, t, half):
            ref = pipeline.avpvs_siti_step(*(p[lane, lo:lo + half] for p in planes),
                                           DST_H, DST_W, prev_last=prev)
            for k in range(3):
                require(torch.equal(out[k][lane, lo:lo + half], ref[k]),
                        f"sharded step: lane {lane} frames {lo}+ plane {k} differ")
            for k in (3, 4):
                e = max_abs(out[k][lane, lo:lo + half], ref[k])
                err = max(err, e)
                require(e <= 1e-3, f"sharded step: lane {lane} SI/TI off by {e}")
            prev = ref[0][-1].clone()
            del ref
    require(float(out[4][0, half]) > 0.0, "sharded step: no TI at the time boundary")
    del out
    ms = time_ms(lambda: step(*planes), reps=3)
    log(f"mesh sharded step: {b}x{t} frames 1080p -> 2160p lanczos, launches {launches}, "
        f"SI/TI max err {err}, {ms:.4f} ms a call on the device")
    del planes
    torch.cuda.empty_cache()
    return {"launches": launches, "siti_max_err": err, "device_ms_per_call": ms,
            "frames": b * t}


def run_mesh_stall(dev, mesh) -> dict:
    """Phase 12 (c): the sharded stall renderer over the mesh's 4 slots on
    phase 7's first stalled chunk (its AVPVS frames rebuilt from phase 4's
    clip), spinner and skipping mode, against the single-device
    compositor; then make_batch_metrics_step on the mesh against one
    slot."""
    chunk = avpvs.CHUNK
    events = [[2.0, 1.0], [7.5, 0.5]]
    src = synthetic_clip(CLIP_FRAMES, chunk, False, SEED + CLIP_FRAMES)  # phase 4's clip
    rgba = synthetic_spinner(SEED + 5)
    result = {}
    outs = {}
    for skipping in (False, True):
        plan = ov.plan_stalling(CLIP_FRAMES, CANVAS_FPS, events, skipping=skipping)
        first = int(np.flatnonzero(plan.stall_mask)[0]) // chunk if not skipping else 1
        lo = first * chunk
        sel = plan.src_idx[lo: lo + chunk]
        gathered = []
        for p, (h, w) in enumerate(PLANE_DIMS):
            frames = np.stack([src[k // chunk][p][k % chunk] for k in sel])
            gathered.append(ck.resize_frames_fused(torch.from_numpy(frames).to(dev), h, w, "bicubic"))
        masks = [m[lo: lo + len(sel)] for m in (plan.stall_mask, plan.black_mask, plan.phase)]
        single = avpvs.make_stall_compositor("yuv420p", rgba, skipping, 64, device=dev)
        sharded = avpvs.make_stall_compositor("yuv420p", rgba, skipping, 64, mesh=mesh)
        ref = single(gathered, *masks)
        got, launches, _ = counted(lambda: sharded(gathered, *masks))
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"sharded stall ({'freeze' if skipping else 'spinner'}): differs from one device")
        require(launches == launches_want(), f"sharded stall: launches {launches}")
        ms = time_ms(lambda: sharded(gathered, *masks), reps=3)
        single_ms = time_ms(lambda: single(gathered, *masks), reps=3)
        tag = "skipping" if skipping else "spinner"
        result[tag] = {"chunk": first, "frames": len(sel), "device_ms": ms,
                       "single_device_ms": single_ms}
        log(f"mesh stall {tag}: chunk {first} ({len(sel)} frames) identical to one device; "
            f"{ms:.3f} ms sharded over {len(mesh.devices)} slots, {single_ms:.3f} ms single")
        outs[tag] = (gathered[0], got[0])
        del gathered, got, ref
    # the batch metrics step on the mesh and on one slot: 2 lanes of the
    # chunks' last 16 luma frames, against the spinner composite and against
    # the freeze chunk in reverse order
    ref = torch.stack([outs["spinner"][0][-16:], outs["skipping"][0][-16:]])
    deg = torch.stack([outs["spinner"][1][-16:], outs["skipping"][1][-16:].flip(0)])
    on_mesh = pipeline.make_batch_metrics_step(mesh)(ref, deg)
    one = pipeline.make_batch_metrics_step(pmesh.make_mesh([dev]))(ref, deg)
    require(all(torch.equal(a, b) for a, b in zip(on_mesh, one)),
            "batch metrics step: the mesh differs from one slot")
    require(bool(torch.isfinite(on_mesh[1]).all()), "batch metrics step: SSIM not finite")
    result["batch_metrics_equal_one_slot"] = True
    log(f"mesh batch metrics step: [2, 16] PSNR/SSIM equal on the 2x2 mesh and one slot "
        f"(PSNR min {float(on_mesh[0].min()):.3f})")
    del outs, ref, deg, src
    torch.cuda.empty_cache()
    return result


def run_mesh(dev, workdir: str) -> dict:
    """Phase 12: the (pvs, time) mesh on the card (see the module doc)."""
    mesh = pmesh.make_mesh([dev] * 4, time_parallel=2)
    require(mesh.shape == {"pvs": 2, "time": 2}, f"mesh: shape {mesh.shape}")
    result = {"waves": run_mesh_waves(dev, [dev] * 4, "one_card", workdir),
              "sharded_step": run_mesh_step(dev, mesh),
              "stall": run_mesh_stall(dev, mesh)}
    n = torch.cuda.device_count()
    if n >= 2:
        cards = [torch.device("cuda", i) for i in range(min(n, 4) // 2 * 2)]
        result["distinct_cards"] = run_mesh_waves(dev, cards * (4 // len(cards)),
                                                  "distinct", workdir)
    else:
        log("mesh (d): the distinct-card route was not run (one card visible); the NCCL "
            "halo needs two cards as well")
        result["distinct_cards"] = None
    return result


# ---------------------------------------------------------------------------
# phase 13: the profiling plane on the card
# ---------------------------------------------------------------------------

PROFILE_SEAM_FRAMES = 128
UNPROFILED_TURNS = 3  # wave (a) runs with telemetry off and on, each, before the window


def trace_launches(trace: dict) -> tuple:
    """({LAUNCHES names: kernel events}, {symbol: events}) of the device
    trace's kernels that csrc/*.cu launches, by the names the trace gives."""
    counts, symbols = {}, {}
    for ev in profiling.device_events(trace, "kernel"):
        names = ck.launch_names(ev["name"])
        if names:
            counts[names] = counts.get(names, 0) + 1
            symbols[ev["name"]] = symbols.get(ev["name"], 0) + 1
    return counts, symbols


def window_shares(trace: dict, annotation: str) -> dict:
    """Kernel and copy busy shares of the card inside one record_function
    range of the trace: the union of each kind's intervals over the span
    from the range's first device event to its last (all on the trace's
    own clock)."""
    rng = profiling.annotation_range(trace, annotation)
    require(rng is not None, f"profile: no {annotation} range in the device trace")
    lo, hi = rng
    inside = {kind: [e for e in profiling.device_events(trace, kind) if lo <= float(e["ts"]) <= hi]
              for kind in profiling.DEVICE_EVENT_KINDS}
    every = [e for evs in inside.values() for e in evs]
    require(every, f"profile: no device event inside {annotation}")
    start = min(float(e["ts"]) for e in every)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in every)
    return {"window_ms": (end - start) / 1e3,
            "kernel_share": profiling.busy_share(inside["kernel"], start, end),
            "copy_share": profiling.busy_share(inside["copy"], start, end),
            "kernel_events": len(inside["kernel"]), "copy_events": len(inside["copy"]),
            "copy_bytes": sum(int(e.get("args", {}).get("bytes", 0)) for e in inside["copy"])}


def run_profiled(dev, workdir: str, wave_a: dict, seam: dict, timing: dict) -> dict:
    """Phase 13 (a)-(c): one profiled window on the card (see the module doc)."""
    out = os.path.join(workdir, "profile")
    shutil.rmtree(out, ignore_errors=True)
    seam_chunks = synthetic_clip(PROFILE_SEAM_FRAMES, avpvs.CHUNK, False, SEED + 13)
    lengths = WAVE_CASES[0][1]
    clips = [synthetic_clip(n, avpvs.CHUNK, False, SEED + 31 * i + n)
             for i, n in enumerate(lengths)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    planes = [random_frames(gen, s, 255, torch.uint8, dev) for s in plane_shapes(FLAGSHIP_FRAMES)]
    flagship = pipeline._instrument_step(pipeline.avpvs_siti_step, "avpvs_siti_step")
    mesh = pmesh.make_mesh()
    bucket = p03_batch.bucket_label(DST_H, DST_W, False, SRC_H, SRC_W)

    def wave_lanes(tag):
        sinks = [LaneSink() for _ in lengths]
        return sinks, [p03_batch.Lane(chunks=iter(c), emit=s.emit, n_frames_hint=n,
                                      emit_features=s.feat.extend, name=f"{tag}{i}")
                       for i, (c, s, n) in enumerate(zip(clips, sinks, lengths))]

    # wave (a) unprofiled, in turns with telemetry off and on (a journal
    # attached to both), just before the profiled window and in its warm
    # state: the turns price the wave loop's metrics and spans, the last
    # run with telemetry on beside the profiled one prices the capture
    unprofiled_fps = {"off": [], "on": []}
    journal = os.path.join(workdir, "meshobs_unprofiled")
    for mode in ("off", "on") * UNPROFILED_TURNS:
        serve_tm.reset()
        (serve_tm.enable if mode == "on" else serve_tm.disable)()
        unprof_sinks, lanes = wave_lanes(f"unprofiled_{mode}")
        meshobs.attach_journal(journal)
        try:
            torch.cuda.synchronize()
            t_wave = time.perf_counter()
            p03_batch.run_bucket(lanes, mesh, DST_H, DST_W, "bicubic", (2, 2), False,
                                 chunk=avpvs.CHUNK, bucket=bucket)
            torch.cuda.synchronize()
            unprofiled_fps[mode].append(sum(lengths) / (time.perf_counter() - t_wave))
        finally:
            meshobs.detach_journal()
            shutil.rmtree(journal, ignore_errors=True)
        require(all(s.frames == n for s, n in zip(unprof_sinks, lengths)),
                f"profile: the unprofiled wave (telemetry {mode}) lost frames")
        del unprof_sinks, lanes
    serve_tm.reset()
    serve_tm.enable()
    tracing.get_tracer().clear()
    stamp = serve_tm.unique_stamp()
    meshobs.attach_journal(os.path.join(out, f"meshobs_{stamp}"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launches()
    prof = profiling.Profiler(out, interval_s=0.25, device_trace=True).start(stamp)
    t0 = time.perf_counter()
    try:
        with serve_tm.stage_span("p03"):
            with torch.profiler.record_function("smoke:seam"):
                t_seam = time.perf_counter()
                sink = HostSink(dev)
                try:
                    avpvs.pump_ready(iter(seam_chunks), sink, avpvs.SiTiAccumulator(),
                                     DST_H, DST_W, "yuv420p", device=dev)
                finally:
                    sink.close()
                torch.cuda.synchronize()
                seam_s = time.perf_counter() - t_seam
            sinks, lanes = wave_lanes("profiled")
            with torch.profiler.record_function("smoke:wave"):
                t_wave = time.perf_counter()
                p03_batch.run_bucket(lanes, mesh, DST_H, DST_W, "bicubic", (2, 2), False,
                                     chunk=avpvs.CHUNK, bucket=bucket)
                torch.cuda.synchronize()
                wave_s = time.perf_counter() - t_wave
            with torch.profiler.record_function("smoke:flagship"):
                flagship(*planes, DST_H, DST_W)
                torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        window_peak = torch.cuda.max_memory_allocated(dev)
        sample = profiling.sample_resources()
        stats = torch.cuda.memory_stats(dev)
    finally:
        paths = prof.stop(stamp)
        meshobs.detach_journal()
    window_s = time.perf_counter() - t0
    metrics = serve_tm.REGISTRY.snapshot()
    events = serve_tm.EVENTS.records()
    serve_tm.write_outputs(out, stamp)
    tracing.get_tracer().write_report(out, stamp)
    serve_tm.disable()
    del clips, lanes, planes

    require(all(s.frames == n for s, n in zip(sinks, lengths)) and sink.frames == PROFILE_SEAM_FRAMES,
            "profile: a lane or the seam lost frames")
    require("device_trace_error" not in paths,
            f"profile: the device trace was asked for and not written: {paths.get('device_trace_error')}")
    for key in ("trace", "resources", "device_trace_dir"):
        require(key in paths and os.path.exists(paths[key]), f"profile: no {key} artifact: {paths}")

    # (a) the device trace's kernels against the launch counters
    trace = profiling.load_device_trace(paths["device_trace_dir"])
    kernels = profiling.device_events(trace, "kernel")
    require(kernels, "profile: the device trace holds no kernel events (CUDA activity was "
            "not recorded: is CUPTI missing from this install?)")
    counts, symbols = trace_launches(trace)
    families = {}
    for names in {ck.launch_names(sym) for sym in symbols} | {
            ("resize_frames_fused",), ("si_frames_fused",), ("ti_frames_fused",),
            ("siti_frames_fused", "siti_frames_fused_batch")}:
        want = sum(launches[n] for n in names)
        got = counts.get(names, 0)
        families["+".join(names)] = {"trace": got, "launches": want}
        require(want > 0 and got == want,
                f"profile: {'+'.join(names)}: {got} kernel events in the trace, "
                f"{want} launches counted")
    log(f"phase 13 (a): device trace {len(kernels)} kernel events, ours by family "
        f"{families}; symbols {json.dumps(symbols)}")

    with open(paths["trace"]) as f:
        host = json.load(f)
    spans = {(e.get("cat"), e.get("name")) for e in host["traceEvents"] if e.get("ph") == "X"}
    for want_span in (("device", "wave_step"), ("device", "avpvs_siti_step"),
                      ("transfer", "device_put"), ("transfer", "device_get"),
                      ("decode", "decode")):
        require(want_span in spans, f"profile: merged trace lacks the {want_span} span")
    verdicts = profiling.attribute_run(metrics, events)
    verdict = verdicts.get("p03", {})
    require(verdict.get("verdict") in profiling.VERDICTS
            and {"transfer", "compute"}.isdisjoint(verdict.get("missing", ["?"])),
            f"profile: attribution {verdicts}")

    gauge = {tuple(sorted(s["labels"].items())): s["value"]
             for s in metrics["chain_device_memory_bytes"]["series"]}
    mem = sample["device_memory_by_device"]["cuda:0"]
    want_mem = {"bytes_in_use": stats["allocated_bytes.all.current"],
                "peak_bytes_in_use": stats["allocated_bytes.all.peak"],
                "bytes_limit": torch.cuda.mem_get_info(dev)[1]}
    for kind, val in want_mem.items():
        require(mem[kind] == val == gauge[(("device", "cuda:0"), ("kind", kind))],
                f"profile: chain_device_memory_bytes{{cuda:0,{kind}}} "
                f"{gauge.get((('device', 'cuda:0'), ('kind', kind)))} != memory_stats {val}")
    require(mem["peak_bytes_in_use"] >= window_peak,
            f"profile: peak {mem['peak_bytes_in_use']} below the window's {window_peak}")
    log(f"phase 13 (a): verdict {verdict['verdict']} ({verdict['contributors']}), "
        f"memory gauges {mem} equal memory_stats; artifacts {sorted(os.listdir(out))}")

    # (b) busy shares read from the trace, beside the event-timed estimates
    shares = {"seam": window_shares(trace, "smoke:seam"),
              "wave": window_shares(trace, "smoke:wave")}
    seam_chunk_ms = timing["resize_frames_fused"]["ms"] + timing["si_frames_fused"]["ms"] \
        + timing["ti_frames_fused"]["ms"]
    wave_block_ms = timing["resize_frames_fused"]["ms"] + timing["siti_frames_fused_batch"]["ms"]
    n_chunks = -(-PROFILE_SEAM_FRAMES // avpvs.CHUNK)
    estimates = {
        "seam": {"phase4_device_busy_share": seam["device_busy_share"],
                 "kernel_ms_x_launches_over_window": n_chunks * seam_chunk_ms / 1e3 / seam_s},
        "wave": {"kernel_ms_x_launches_over_phase6_window":
                 wave_a["blocks"] * wave_block_ms / 1e3 / wave_a["seconds"],
                 "kernel_ms_x_launches_over_window": wave_a["blocks"] * wave_block_ms / 1e3 / wave_s},
    }
    wave_fps = sum(lengths) / wave_s
    unprof_fps = unprofiled_fps["on"][-1]
    off_med, on_med = (float(np.median(unprofiled_fps[m])) for m in ("off", "on"))
    for name in ("seam", "wave"):
        sh = shares[name]
        log(f"phase 13 (b): {name}: kernels busy {100 * sh['kernel_share']:.2f}%, copies "
            f"{100 * sh['copy_share']:.2f}% of its {sh['window_ms']:.3f} ms on the card "
            f"(trace: {sh['kernel_events']} kernels, {sh['copy_events']} copies, "
            f"{sh['copy_bytes']} bytes); estimates {json.dumps(estimates[name])}")
    log(f"phase 13 (b): wave (a) unprofiled, telemetry off / on in turns: median "
        f"{off_med:.2f} / {on_med:.2f} frames/s (instrumentation cost "
        f"{100 * (off_med / on_med - 1):.1f}%; runs {json.dumps(unprofiled_fps)})")
    log(f"phase 13 (b): wave (a) profiled {wave_fps:.2f} frames/s beside {unprof_fps:.2f} "
        f"frames/s unprofiled just before it (capture overhead "
        f"{100 * (unprof_fps / wave_fps - 1):.1f}%); window {window_s:.2f} s")

    # (c) the readers over the window's directory, as a user runs them
    readers = {}
    for tool, marks in (("run-report", ("bottleneck attribution:", "resources:", "mesh efficiency:")),
                        ("chain-profile", ("lanes (busy seconds", "bottleneck verdicts:"))):
        # chainlint: disable=subprocess-hygiene (the port's own reader on a directory this run wrote, with a timeout; its exit code and output are checked)
        proc = subprocess.run([sys.executable, "-m", "processing_chain_tpu_torch", "tools", tool, out],
                              cwd=ROOT, capture_output=True, text=True, timeout=120)
        require(proc.returncode == 0, f"profile: tools {tool} exited {proc.returncode}: "
                f"{proc.stderr[-1000:]}")
        for mark in marks:
            require(mark in proc.stdout, f"profile: tools {tool} printed no '{mark}'")
        readers[tool] = proc.stdout
    log("phase 13 (c): tools run-report:\n" + readers["run-report"].rstrip())
    log("phase 13 (c): tools chain-profile:\n" + readers["chain-profile"].rstrip())
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "families": families, "symbols": symbols,
            "verdict": verdict, "memory": mem, "window_peak_bytes": window_peak,
            "shares": shares, "estimates": estimates, "seam_s": seam_s,
            "wave_s": wave_s, "wave_frames_per_s_profiled": wave_fps,
            "wave_frames_per_s_unprofiled": unprof_fps,
            "wave_frames_per_s_unprofiled_turns": unprofiled_fps, "window_s": window_s}


# ---------------------------------------------------------------------------
# phase 14: the database
# ---------------------------------------------------------------------------

DB_ID = "P2STR14"
DB_MEDIA_S = 4.5  # media seconds each PVS renders, of its 8-10 s: the phase's cut
DB_CHECK_FRAMES = 1  # frames of each stage's first chunk run again on the CPU
# the SRCs' probe records (a StaticProber stands in for the libav probe)
DB_SRCS = {
    "SRC000.avi": {"width": UHD_W, "height": UHD_H, "pix_fmt": "yuv420p",
                   "r_frame_rate": "60/1", "video_duration": 10.0},
    "SRC001.avi": {"width": SRC_W, "height": SRC_H, "pix_fmt": "yuv420p10le",
                   "r_frame_rate": "30/1", "video_duration": 10.0},
}
# a short test of 4K-capable HRCs: a ladder 640x360 .. 3840x2160 (Q0 drops
# the 60 fps SRC to 30 fps), a mid-PVS stall (HRC002, two segments), a
# freeze (HRC003), an initial stall (HRC004); SRC001 is paired only with
# the HRCs whose widest level fits its 1920 pixels (the upscale guard)
DB_YAML = """\
databaseId: {db_id}
syntaxVersion: 6
type: short
qualityLevelList:
  Q0: {{index: 0, videoCodec: h264, videoBitrate: 600, width: 640, height: 360, fps: 30}}
  Q1: {{index: 1, videoCodec: h264, videoBitrate: 2500, width: 1280, height: 720, fps: original}}
  Q2: {{index: 2, videoCodec: h264, videoBitrate: 6000, width: 1920, height: 1080, fps: original}}
  Q3: {{index: 3, videoCodec: h265, videoBitrate: 16000, width: 3840, height: 2160, fps: original}}
codingList:
  VC01: {{type: video, encoder: libx264, passes: 2, iFrameInterval: 2, preset: medium}}
  VC02: {{type: video, encoder: libx265, passes: 1, iFrameInterval: 2, preset: medium}}
srcList:
  SRC000: SRC000.avi
  SRC001: SRC001.avi
hrcList:
  HRC000: {{videoCodingId: VC01, eventList: [[Q0, 10]]}}
  HRC001: {{videoCodingId: VC01, eventList: [[Q1, 10]]}}
  HRC002: {{videoCodingId: VC01, eventList: [[Q2, 4], [stall, 1.0], [Q2, 4]]}}
  HRC003: {{videoCodingId: VC02, eventList: [[Q3, 8], [freeze, 0.5]]}}
  HRC004: {{videoCodingId: VC01, segmentDuration: 8, eventList: [[stall, 0.5], [Q1, 8]]}}
pvsList:
  - {db_id}_SRC000_HRC000
  - {db_id}_SRC000_HRC001
  - {db_id}_SRC000_HRC002
  - {db_id}_SRC000_HRC003
  - {db_id}_SRC000_HRC004
  - {db_id}_SRC001_HRC000
  - {db_id}_SRC001_HRC002
  - {db_id}_SRC001_HRC004
postProcessingList:
  - {{type: pc, displayWidth: 3840, displayHeight: 2160, codingWidth: 3840, codingHeight: 2160}}
  - {{type: tablet, displayWidth: 2560, displayHeight: 1440, codingWidth: 2560, codingHeight: 1440}}
  - {{type: mobile, displayWidth: 1920, displayHeight: 1080, codingWidth: 1920, codingHeight: 1080}}
"""


def write_database(root: str, db_id: str, text: str, srcs: dict) -> str:
    """The database folder `root/db_id` with its YAML and an empty file
    for each SRC (probed through a StaticProber); returns the YAML path."""
    src_dir = os.path.join(root, db_id, "srcVid")
    os.makedirs(src_dir, exist_ok=True)
    for name in srcs:
        fsio.atomic_write_text(os.path.join(src_dir, name), "")
    path = os.path.join(root, db_id, db_id + ".yaml")
    fsio.atomic_write_text(path, text.format(db_id=db_id))
    return path


def database_source(src, seed: int) -> SyntheticSrc:
    """The synthetic stand-in for the decoded SRC `src` (a config `Src`):
    its geometry, bit depth and length."""
    info = src.stream_info
    return SyntheticSrc(int(round(src.get_duration() * src.get_fps())), src.uses_10_bit(), seed,
                        info["height"], info["width"])


def media_window(pvs, media_s: float) -> list:
    """(segment, media seconds of it rendered) of the segments that start
    in the PVS's first `media_s` seconds of media."""
    return [(seg, min(float(seg.duration), media_s - seg.start_time))
            for seg in pvs.segments if seg.start_time < media_s]


def canvas_input(p01: list, rate: float, chunk: int):
    """p01's host chunks of each segment on the AVPVS canvas's time grid:
    exactly round(seconds x rate) frames a segment, output k taking frame
    floor(k / rate x fps + 0.5) of the segment (the long path's
    `_segment_canvas_chunks`; for one segment at the 60 fps canvas, the
    short path's -f60 resample)."""
    for run in p01:
        fps = run["plan"][3]
        frames = pfe.iter_chunk_frames([torch.from_numpy(a) for a in c] for c in run["chunks"])
        yield from pfe.stream_monotonic_gather(
            frames, lambda k, f=fps: int(np.floor(k / rate * f + 0.5)),
            int(round(run["seconds"] * rate)), chunk)


def render_database_pvs(pvs, src: SyntheticSrc, device, spinner, stage, sink,
                        media_s: float = DB_MEDIA_S, chunk: int = avpvs.CHUNK) -> dict:
    """One PVS's device path, driven from its domain objects: each
    segment of its first `media_s` seconds through p01's device half
    (`plan_segment_frames`, `scaled_chunks`) from `src`'s frames; the
    AVPVS canvas (`avpvs_dimensions`, `canvas_fps`) through `pump_ready`;
    with buffering, `plan_stalling` over `get_buff_events_media_time()`
    and `pump_stalled`; each post-processing's `cpvs_plan` through its
    context pipeline (`make_cpvs_transform`). `stage(name, fn)` runs each
    step and returns its result; `sink(name)` makes each writer."""
    out = {"p01": []}
    for seg, secs in media_window(pvs, media_s):
        plan = segments.plan_segment_frames(seg)
        th, tw, target_fps, _ = plan
        src_fps = seg.src.get_fps()
        first, n = int(round(seg.start_time * src_fps)), int(round(secs * src_fps))

        def p01(seg=seg, src_fps=src_fps, first=first, n=n, th=th, tw=tw,
                target_fps=target_fps):
            return list(segments.scaled_chunks(src.chunks(first, n, chunk), src_fps, target_fps,
                                               th, tw, seg.target_pix_fmt, device=device))

        out["p01"].append({"segment": seg, "seconds": secs, "first": first, "n_src": n,
                           "plan": plan, "chunks": stage(f"p01 {seg.filename}", p01)})
    rate = avpvs.canvas_fps(pvs)
    w, h = avpvs.avpvs_dimensions(pvs)
    pix_fmt = pvs.get_pix_fmt_for_avpvs()
    out.update(rate=rate, w=w, h=h, pix_fmt=pix_fmt, feat=avpvs.SiTiAccumulator())
    writer = sink("canvas")
    out["canvas"] = canvas = KeepSink(writer.put)

    def render(writer=writer):
        try:
            avpvs.pump_ready(canvas_input(out["p01"], rate, chunk), canvas, out["feat"],
                             h, w, pix_fmt, device=device)
        finally:
            writer.close()

    stage("canvas", render)
    final = canvas
    out["stall"] = None
    if pvs.has_buffering():
        skipping = pvs.has_framefreeze()
        plan = ov.plan_stalling(canvas.frames, rate, pvs.get_buff_events_media_time(),
                                skipping=skipping, black_frame=True, n_rotations=64)
        comp = avpvs.make_stall_compositor(pix_fmt, spinner, skipping, 64, device=device)
        writer = sink("stalled")
        final = stalled = KeepSink(writer.put)

        def stall(writer=writer):
            try:
                avpvs.pump_stalled(pfe.iter_chunk_frames(canvas.chunks), plan, comp, stalled,
                                   chunk)
            finally:
                writer.close()

        stage("stall", stall)
        out["stall"] = {"plan": plan, "skipping": skipping, "sink": stalled}
    out["final"] = final
    out["cpvs"] = []
    for pp in pvs.test_config.post_processings:
        plan = cp.cpvs_plan(pvs, pp, h)
        writer = sink(f"cpvs {pp.processing_type}")
        pipe = fused._ContextPipeline(writer, plan, pp, pix_fmt, rate, False, chunk)

        def cpvs(pipe=pipe):
            for c in final.chunks:
                pipe.feed(c)
            pipe.finish()

        stage(f"cpvs {pp.processing_type}", cpvs)
        out["cpvs"].append({"pp": pp, "plan": plan, "sink": writer})
    out["wo_buffer_plan"] = avpvs._wo_buffer_plan(pvs, w, h, pix_fmt, False, True,
                                                  device=device)
    return out


def chunk_rows(chunks, rows) -> list:
    """Planes of the frames numbered `rows` of a stream of chunks."""
    where = [(c, i) for c, planes in enumerate(chunks) for i in range(planes[0].shape[0])]
    return [torch.stack([chunks[where[k][0]][p][where[k][1]] for k in rows]) for p in range(3)]


def plane_err(got, want) -> float:
    """Largest absolute difference of two lists of planes, computed where
    `want` lies (on the card for the plain path's planes)."""
    return max(max_abs(torch.as_tensor(a).to(b.device), b)
               for a, b in zip(got, (torch.as_tensor(w) for w in want)))


class plain_resize:
    """Within it, `cuda_kernels.resize_frames_fused` is its plain version
    (`resize_frames_plain`, on the tensors' device, no launch): a
    transform run so is the card's plain path."""

    def __enter__(self):
        self.fused = ck.resize_frames_fused
        ck.resize_frames_fused = lambda frames, h, w, kernel="lanczos": \
            ck.resize_frames_plain(frames, h, w, kernel)
        self.launches = dict(ck.LAUNCHES)
        return self

    def __exit__(self, *exc):
        ck.resize_frames_fused = self.fused
        if exc[0] is None:
            require(dict(ck.LAUNCHES) == self.launches, "the plain path launched a kernel")


def check_database_pvs(dev, pvs, src: SyntheticSrc, r: dict, launches: dict,
                       compositors: dict) -> dict:
    """Phase 14's checks of one PVS's run `r`: frame counts against the
    plans, each stage's launches, each stage's first chunk against the
    plain path on the card (the stall pass: also the chunk holding its
    first stalled frame and a chunk's worth of frames from that frame)
    and its first frames against the CPU route (the
    stall pass: from its first stalled frame). `compositors` keeps the
    card's and the CPU's stall compositor of each (pix_fmt, skipping)
    across PVSes."""
    chunk, check = avpvs.CHUNK, DB_CHECK_FRAMES
    pix_fmt, rate, w, h = r["pix_fmt"], r["rate"], r["w"], r["h"]
    ten_bit = "10" in pix_fmt
    tol = 1 if ten_bit else 0  # u8 planes bit-exact; u16 within a code value
    atol = 1e-2 if ten_bit else 1e-3
    errs = {}
    # p01: each segment's frames, launches, first chunk
    canvas_chunks = 0
    want_canvas_resize = 0
    for run in r["p01"]:
        seg, (th, tw, target_fps, _) = run["segment"], run["plan"]
        src_fps = seg.src.get_fps()
        name = f"p01 {seg.filename}"
        got = sum(c[0].shape[0] for c in run["chunks"])
        want = len(fps_ops.select_indices(run["n_src"], src_fps, target_fps or src_fps))
        require(got == want, f"{pvs.pvs_id} {name}: {got} frames, the fps plan keeps {want}")
        scaled = (th, tw) != tuple(src.shapes[0])
        require(launches[name] == launches_want(
            resize_frames_fused=3 * len(run["chunks"]) if scaled else 0),
            f"{pvs.pvs_id} {name}: launches {launches[name]}")
        first = next(src.chunks(run["first"], min(chunk, run["n_src"]), chunk))
        if target_fps not in (None, src_fps):
            first = next(fps_ops.stream_select(iter([first]), src_fps, target_fps))
        sub = fr.chroma_subsampling(seg.target_pix_fmt)
        dims = [(th, tw), (th // sub[0], tw // sub[1]), (th // sub[0], tw // sub[1])]
        on_card = [torch.from_numpy(p).to(dev) for p in first]
        plain = fr.to_uint8([ck.resize_frames_plain(p, a, b, "bicubic") if scaled else p
                             for p, (a, b) in zip(on_card, dims)], seg.uses_10_bit())
        errs[f"{name} plain"] = e = plane_err(run["chunks"][0], plain)
        require(e <= tol, f"{pvs.pvs_id} {name}: first chunk {e} from the plain resize")
        cpu = next(segments.scaled_chunks(iter([[p[:check] for p in first]]), src_fps, None,
                                          th, tw, seg.target_pix_fmt, device="cpu"))
        errs[f"{name} cpu"] = e = plane_err([a[:check] for a in run["chunks"][0]], cpu)
        require(e <= tol, f"{pvs.pvs_id} {name}: first frames {e} from the CPU route")
        n_seg = int(round(run["seconds"] * rate))
        n_chunks = -(-n_seg // chunk)
        canvas_chunks += n_chunks
        want_canvas_resize += 3 * n_chunks if (th, tw) != (h, w) else 0
    # the canvas
    canvas = r["canvas"]
    n_canvas = sum(int(round(run["seconds"] * rate)) for run in r["p01"])
    require(canvas.frames == n_canvas,
            f"{pvs.pvs_id}: canvas {canvas.frames} frames, the plans say {n_canvas}")
    require(launches["canvas"] == launches_want(
        resize_frames_fused=want_canvas_resize, si_frames_fused=canvas_chunks,
        ti_frames_fused=canvas_chunks), f"{pvs.pvs_id} canvas: launches {launches['canvas']}")
    first = [p.to(dev) for p in next(canvas_input(r["p01"], rate, chunk))]
    sub = fr.chroma_subsampling(pix_fmt)
    dims = [(h, w), (h // sub[0], w // sub[1]), (h // sub[0], w // sub[1])]
    plain = [ck.resize_frames_plain(p, a, b, "bicubic") if tuple(p.shape[1:]) != (a, b) else p
             for p, (a, b) in zip(first, dims)]
    errs["canvas plain"] = e = plane_err(canvas.chunks[0], plain)
    require(e <= tol, f"{pvs.pvs_id} canvas: first chunk {e} from the plain resize")
    si = torch.cat(r["feat"].si).cpu()
    ti = torch.cat(r["feat"].ti).cpu()
    n0 = first[0].shape[0]
    errs["canvas si"] = max_abs(si[:n0], ck.si_frames_plain(plain[0]).cpu())
    errs["canvas ti"] = max_abs(ti[:n0], ck.ti_frames_plain(plain[0]).cpu())
    require(max(errs["canvas si"], errs["canvas ti"]) <= atol,
            f"{pvs.pvs_id} canvas: SI/TI {errs['canvas si']}, {errs['canvas ti']} from plain")
    cpu_sink, cpu_feat = KeepSink(), avpvs.SiTiAccumulator()
    avpvs.pump_ready(iter([[p[:check].cpu() for p in first]]), cpu_sink, cpu_feat, h, w,
                     pix_fmt, device="cpu")
    errs["canvas cpu"] = e = plane_err([p[:check] for p in canvas.chunks[0]],
                                       cpu_sink.chunks[0])
    errs["canvas cpu si/ti"] = max(max_abs(si[:check], cpu_feat.si[0]),
                                   max_abs(ti[:check], cpu_feat.ti[0]))
    require(e <= tol and errs["canvas cpu si/ti"] <= atol,
            f"{pvs.pvs_id} canvas: first frames {e} (SI/TI {errs['canvas cpu si/ti']}) "
            "from the CPU route")
    del first, plain
    frames = {"canvas": n_canvas}
    # the stall pass
    if r["stall"] is not None:
        plan, sink = r["stall"]["plan"], r["stall"]["sink"]
        require(sink.frames == plan.n_out,
                f"{pvs.pvs_id} stall: {sink.frames} frames, the plan says {plan.n_out}")
        require(launches["stall"] == launches_want(), f"{pvs.pvs_id} stall: {launches['stall']}")
        k0 = int(np.flatnonzero(plan.stall_mask)[0])

        def composite(device, rows):
            """The plan's rows composited again on `device` from the canvas."""
            key = (device, pix_fmt, r["stall"]["skipping"])
            if key not in compositors:
                compositors[key] = avpvs.make_stall_compositor(
                    pix_fmt, synthetic_spinner(SEED + 5), key[2], 64, device=device)
            gathered = chunk_rows(canvas.chunks, [int(plan.src_idx[k]) for k in rows])
            masks = [m[rows.start: rows.stop]
                     for m in (plan.stall_mask, plan.black_mask, plan.phase)]
            return compositors[key]([g.to(device) for g in gathered], *masks)

        # the first chunk, the chunk holding the first stalled frame, and
        # the chunk's worth of frames from it
        for lo in sorted({0, k0 // chunk * chunk, k0}):
            rows = range(lo, min(lo + chunk, plan.n_out))
            got = chunk_rows(sink.chunks, list(rows))
            require(all(torch.equal(a, b) for a, b in zip(got, composite(dev, rows))),
                    f"{pvs.pvs_id} stall: frames {lo}-{rows.stop - 1} differ from the "
                    "composite on the card's plain path")
        rows = range(k0, min(k0 + check, plan.n_out))
        got = chunk_rows(sink.chunks, list(rows))
        require(all(torch.equal(a.cpu(), b) for a, b in zip(got, composite("cpu", rows))),
                f"{pvs.pvs_id} stall: frames {rows.start}-{rows.stop - 1} differ from the "
                "CPU composite")
        frames["stalled"] = plan.n_out
    # the CPVS contexts
    final = r["final"]
    for ctx in r["cpvs"]:
        pp, plan, sink = ctx["pp"], ctx["plan"], ctx["sink"]
        name = f"cpvs {pp.processing_type}"
        fps = plan["fps"]
        want = final.frames if fps in (None, rate) else fps_frames(final.frames, rate, fps)
        require(sink.frames == want, f"{pvs.pvs_id} {name}: {sink.frames} frames, not {want}")
        per_chunk = ((2 if "420" in pix_fmt else 0) if plan["context"] == "pc"
                     else 3 if plan["scale"] else 0)
        require(launches[name] == launches_want(resize_frames_fused=per_chunk * sink.chunks),
                f"{pvs.pvs_id} {name}: launches {launches[name]}")
        require(fps in (None, rate), f"{pvs.pvs_id} {name}: the check needs a 1:1 context")
        with plain_resize():
            plain = cp.make_cpvs_transform(plan, pp, pix_fmt, False)(list(final.chunks[0]))
        errs[f"{name} plain"] = e = plane_err(sink.first, plain)
        require(e == 0, f"{pvs.pvs_id} {name}: first chunk {e} from the plain path")
        del plain
        cpu = cp.make_cpvs_transform(plan, pp, pix_fmt, False)(
            [p[:check].cpu() for p in final.chunks[0]])
        got = [a[:check] for a in sink.first]
        require(all(torch.equal(a, b) for a, b in zip(got, cpu)),
                f"{pvs.pvs_id} {name}: first frames differ from the CPU transform")
        frames[pp.processing_type] = sink.frames
    return {"frames": frames, "errors": errs}


def run_database_pvs(dev, pvs, src: SyntheticSrc, spinner, compositors: dict) -> dict:
    launches, seconds = {}, {}

    def stage(name, fn):
        out, launches[name], seconds[name] = counted(fn)
        return out

    r = render_database_pvs(pvs, src, dev, spinner, stage, lambda name: HostSink(dev))
    total = sum(seconds.values())
    t0 = time.perf_counter()
    checked = check_database_pvs(dev, pvs, src, r, launches, compositors)
    check_s = time.perf_counter() - t0
    path = {k: sum(v[k] for v in launches.values()) for k in ck.LAUNCHES}
    for kernel in ("resize_frames_fused", "si_frames_fused", "ti_frames_fused"):
        require(path[kernel] > 0, f"{pvs.pvs_id}: no {kernel} launch")
    # device ms of one resident canvas chunk (resize x3, quantize, SI, TI)
    first = [p.to(dev) for p in next(canvas_input(r["p01"], r["rate"], avpvs.CHUNK))]
    sub = fr.chroma_subsampling(r["pix_fmt"])

    def render_chunk():
        scaled = fr.scale_yuv_frames(first, r["h"], r["w"], "bicubic", sub)
        avpvs.SiTiAccumulator().update(fr.quantize_device(scaled, "10" in r["pix_fmt"])[0])

    device_ms = time_ms(render_chunk, reps=3)
    hashes = {"wo_buffer": keys.plan_hash(r["wo_buffer_plan"]),
              **{c["pp"].processing_type: keys.plan_hash(c["plan"]) for c in r["cpvs"]}}
    segs = [f"{run['segment'].quality_level.ql_id} {run['plan'][1]}x{run['plan'][0]}@"
            f"{run['plan'][3]:g} {run['seconds']:g} s" for run in r["p01"]]
    result = {
        "canvas": f"{r['w']}x{r['h']}@{r['rate']:g} {r['pix_fmt']}", "segments": segs,
        "frames": checked["frames"], "seconds": total, "stage_seconds": seconds,
        "frames_per_s": r["final"].frames / total, "device_ms_per_chunk": device_ms,
        "frames_per_device_chunk": first[0].shape[0], "launches": path,
        "plan_hashes": hashes, "max_err": checked["errors"], "check_s": check_s,
        "events": pvs.get_buff_events_media_time(),
    }
    log(f"phase 14 {pvs.pvs_id}: canvas {result['canvas']}, segments {segs}, frames "
        f"{checked['frames']}, {result['frames_per_s']:.2f} frames/s ({total:.3f} s), device "
        f"{device_ms:.4f} ms a {first[0].shape[0]}-frame chunk, launches {path}, plans "
        f"{ {k: v[:16] for k, v in hashes.items()} }; checks {check_s:.1f} s")
    del r, first
    torch.cuda.empty_cache()
    return result


def run_database(dev, workdir: str) -> dict:
    yaml_path = write_database(workdir, DB_ID, DB_YAML, DB_SRCS)
    tc = TestConfig(yaml_path, prober=StaticProber(DB_SRCS))
    require(list(tc.pvses) == tc.data["pvsList"],
            f"{DB_ID}: PVSes {list(tc.pvses)} != {tc.data['pvsList']}")
    spans = sorted({sum(float(s.duration) for s in p.segments) for p in tc.pvses.values()})
    log(f"phase 14: {DB_ID} loaded through TestConfig: {len(tc.pvses)} PVSes, "
        f"{len(tc.segments)} segments, {len(tc.post_processings)} post-processings; cut: "
        f"each PVS renders its first {DB_MEDIA_S:g} s of media (of {spans} s), at full width")
    spinner = synthetic_spinner(SEED + 5)
    out, sources, compositors = {}, {}, {}
    for pvs_id, pvs in tc.pvses.items():
        sid = pvs.src.src_id
        if sid not in sources:
            sources[sid] = database_source(pvs.src, SEED + 14 + len(sources))
        out[pvs_id] = run_database_pvs(dev, pvs, sources[sid], spinner, compositors)
    return {"database": DB_ID, "media_s": DB_MEDIA_S, "pvses": out}


# ---------------------------------------------------------------------------
# phase 15: the serve control plane
# ---------------------------------------------------------------------------

CONTROL_GEO = {"frames": 8, "src_h": SRC_H, "src_w": SRC_W, "dst_h": DST_H, "dst_w": DST_W}
CONTROL_ARTIFACT = CONTROL_GEO["frames"] * DST_H * DST_W * 3 // 2  # Y, U and V of one unit
# the store holds step 1's six plans; a seventh sets the completion hook
# evicting
CONTROL_BUDGET = 6 * CONTROL_ARTIFACT + (1 << 20)
# the soak's own contract (tools/fleet_doctor.py run_soak) and the
# committed reference evidence ALERTS_r20.json
SOAK_EXPECTED = {"slo_burn_queue_wait", "store_eviction_regret", "fleet_replica_stale"}
SOAK_TOLERATED = SOAK_EXPECTED | {"slo_burn_e2e", "slo_burn_execution"}


def _control_body(srcs, tenant="lab-a") -> dict:
    return {"tenant": tenant, "database": "P2STR01", "srcs": list(srcs), "hrcs": ["HRC001"],
            "params": dict(CONTROL_GEO)}


def _tool(args: list, timeout: float, cwd: str = ROOT,
          check: bool = True) -> subprocess.CompletedProcess:
    """One `python -m processing_chain_tpu_torch tools ...` process from
    the checkout `cwd`; with `check`, a non-zero exit fails the run."""
    # chainlint: disable=subprocess-hygiene (one tool process with a timeout; its exit code is checked by the caller)
    proc = subprocess.run([sys.executable, "-m", "processing_chain_tpu_torch", "tools", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout)
    require(not check or proc.returncode == 0, f"tools {args[0]}: exit {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    return proc


def control_soak(workdir: str) -> dict:
    """Phase 15 (a): `tools fleet-doctor --soak` as a process (the
    synthetic executor), held to ALERTS_r20.json's invariants."""
    root = os.path.join(workdir, "soak")
    out = os.path.join(workdir, "soak.json")
    log(f"phase 15 (a): host before the soak: {host_load()}")
    t0 = time.perf_counter()
    _tool(["fleet-doctor", "--soak", "--root", root, "--out", out], timeout=180)
    soak_s = time.perf_counter() - t0
    with open(out) as f:
        report = json.load(f)
    fired = set(report["alerts"]["fired"])
    control = report["phases"]["control"]
    breach = report["phases"]["breach"]["scale"]
    recovery = report["phases"]["recovery"]["scale"]
    lifecycle = {k: v["state"] for k, v in report["alerts"]["lifecycle"].items()}
    # an alert's seconds from firing to resolving: about one control
    # tick's spacing for the regret step, against the 0.3 s fast window
    durations = {k: v.get("duration_s") for k, v in report["alerts"]["lifecycle"].items()}
    log(f"phase 15 (a): breach soak in {soak_s:.1f} s: ok {report['ok']}, failures "
        f"{report['failures']}, control alerts {control['alerts_fired']}, fired "
        f"{report['alerts']['fired']}, lifecycle {lifecycle}, firing seconds {durations}, "
        f"scale under breach "
        f"{breach['current']} -> {breach['desired']}, after recovery "
        f"{recovery['replicas_current']} -> {recovery['replicas_desired']} {recovery['reasons']}")
    require(report["ok"] is True and report["failures"] == [], f"soak: {report['failures']}")
    require(control["alerts_fired"] == {}, f"soak: control fired {control['alerts_fired']}")
    require(SOAK_EXPECTED <= fired and fired <= SOAK_TOLERATED,
            f"soak: fired {sorted(fired)}, want {sorted(SOAK_EXPECTED)} within "
            f"{sorted(SOAK_TOLERATED)}")
    require(lifecycle and all(s == "resolved" for s in lifecycle.values()),
            f"soak: lifecycle {lifecycle}")
    require(breach["desired"] > breach["current"], f"soak: breach scale {breach}")
    require(recovery["replicas_desired"] == recovery["replicas_current"]
            and "steady" in recovery["reasons"], f"soak: recovery scale {recovery}")
    shutil.rmtree(root, ignore_errors=True)
    return {"seconds": soak_s, "fired": report["alerts"]["fired"], "lifecycle": lifecycle,
            "breach_scale": [breach["current"], breach["desired"]],
            "recovery_scale": [recovery["replicas_current"], recovery["replicas_desired"]]}


def _post_control(url: str, body: dict) -> dict:
    code, raw = _http(url + "/v1/requests", body)
    require(code == 202, f"control: POST {body['srcs']} -> {code} {raw[:300]!r}")
    return json.loads(raw)


def _check_artifacts(dev, svc, url: str, units: dict, shas: dict) -> int:
    """Every unit's artifact over HTTP against the plain resize of its
    seeded YUV on the card; records each sha256 in `shas`. Returns the
    bytes read."""
    n_bytes = 0
    for pvs, u in sorted(units.items()):
        require(u["state"] == "done", f"control: unit {pvs} {u['state']}")
        code, digest, n = _http_sha256(url + u["artifact"])
        require(code == 200 and n == CONTROL_ARTIFACT,
                f"control: {pvs}: GET -> {code}, {n} bytes, not {CONTROL_ARTIFACT}")
        _, src, hrc = pvs.split("_")
        unit = serve_api.Unit("P2STR01", src, hrc, dict(CONTROL_GEO))
        require(svc.store.plan_hash(svc.executor.plan(unit)) == u["plan"],
                f"control: {pvs}: plan hash differs")
        ref = serve_reference(dev, svc.executor, unit, CONTROL_GEO)
        require(digest == ref, f"control: {pvs}: artifact differs from the plain resize")
        require(shas.setdefault(u["plan"], digest) == digest,
                f"control: {pvs}: bytes differ from the plan's first run")
        n_bytes += n
    return n_bytes


def _new_alerts(root: str, seen: int) -> list:
    records = serve_alerts.read_journals(serve_alerts.alerts_dir(root))
    return [r for r in records[seen:] if r.get("kind") == "fired"]


def run_control(dev, workdir: str) -> dict:
    """Phase 15: the serve control plane (see the module doc)."""
    base = os.path.join(workdir, "control")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    try:
        with ram_root("phase 15 (a)") as ram:
            soak = control_soak(ram)
        result = _drive_control(dev, os.path.join(base, "fleet"))
        result["soak"] = soak
        return result
    finally:
        meshobs.detach_journal()
        shutil.rmtree(base, ignore_errors=True)
        torch.cuda.empty_cache()


def _drive_control(dev, root: str) -> dict:
    # one unit's predicted seconds, as POST predicts it (the
    # reference's CPU-fitted base: the calibration scale is 1.0 here)
    probe = DeviceWaveExecutor(device=dev)
    fpix = CONTROL_GEO["frames"] * CONTROL_GEO["dst_h"] * CONTROL_GEO["dst_w"]
    require(probe.cost_features({"params": CONTROL_GEO})
            == {"dev_fmpix": fpix / 1e6, "out_bytes": fpix * 1.5},
            "control: the wave executor's cost features")
    unit_s = serve_cost.predict_unit_cost(probe, {"params": CONTROL_GEO})
    admission_s = 6 * unit_s      # a 4-unit request passes, an 8-unit one does not
    wave_budget_s = 2.5 * unit_s  # waves pack to two units by predicted seconds
    svcs = {}
    for name in ("w-a", "w-b"):
        svcs[name] = ChainServeService(
            root=root, port=0, executor="wave", device=dev, replica=name,
            info_path=os.path.join(root, f"serve-info-{name}.json"), workers=1,
            wave_width=4, poll_s=0.1, control_interval_s=0.15, alert_window_scale=0.001,
            store_budget_bytes=CONTROL_BUDGET, admission_budget_s=admission_s,
            wave_budget_s=wave_budget_s, cost_calibrate=True, lease_s=2.0)
    a, b = svcs["w-a"], svcs["w-b"]
    for svc in svcs.values():
        require(svc.pressure.budget_bytes == CONTROL_BUDGET, "control: store budget not wired")
    try:
        for svc in svcs.values():
            svc.start()
        url_a, url_b = a.server.url, b.server.url
        serve_tm.EVENTS.clear()
        torch.cuda.synchronize()
        ck.reset_launches()
        t_path = time.perf_counter()
        frames = CONTROL_GEO["frames"]
        shas: dict = {}
        steps: dict = {}

        # 1. 4 units to A and 4 to B, two of B's A's plans: 6 executions
        t0 = time.perf_counter()
        acc_a = _post_control(url_a, _control_body(["SRC101", "SRC102", "SRC103", "SRC104"]))
        # B posts once A's records are on disk and B's 0.1 s poll has
        # merged them (cross-replica dedup is eventual within the queue's
        # 0.25 s refresh throttle)
        while True:
            doc = json.loads(_http(url_a + acc_a["url"])[1])
            if doc["state"] != "active" or any(
                    u["state"] in ("running", "done") for u in doc["units"].values()):
                break
            require(time.perf_counter() - t0 < 120, "control: A never started running")
            time.sleep(0.01)
        time.sleep(0.3)
        acc_b = _post_control(url_b, _control_body(["SRC103", "SRC104", "SRC105", "SRC106"],
                                                   tenant="lab-b"))
        doc_a, _ = _wait_done(url_a, acc_a["request"], 300)
        doc_b, _ = _wait_done(url_b, acc_b["request"], 300)
        t1 = time.perf_counter() - t0
        done1 = time.monotonic()
        require(doc_a["state"] == "done" and doc_b["state"] == "done",
                f"control: A {doc_a['state']} {doc_a.get('error')}, B {doc_b['state']} "
                f"{doc_b.get('error')}")
        units1 = {**doc_a["units"], **doc_b["units"]}
        plans1 = {u["plan"] for u in units1.values()}
        require(len(plans1) == 6, f"control: {len(plans1)} distinct plans, not 6")
        want1 = launches_want(resize_frames_fused=3 * 6, siti_frames_fused_batch=6)
        require(dict(ck.LAUNCHES) == want1,
                f"control: step 1 launches {dict(ck.LAUNCHES)} != {want1} (dedup)")
        bytes1 = _check_artifacts(dev, b, url_b, units1, shas)
        waves = [e for e in serve_tm.EVENTS.records() if e.get("event") == "serve_wave"]
        packs = [(e["units"], e.get("predicted_s")) for e in waves]
        require(waves and all(e["units"] <= 2 for e in waves),
                f"control: waves {packs} not packed to {wave_budget_s:.3f} predicted s")
        healthy = _new_alerts(root, 0)
        require(healthy == [], f"control: the healthy window fired {healthy}")
        steps["1_two_replicas"] = {"frames_per_s": 6 * frames / t1, "seconds": t1,
                                   "outcomes_b": acc_b["outcomes"], "waves": packs}
        log(f"phase 15 (b) 1: 6 plans from 8 units on two replicas in {t1:.3f} s "
            f"({6 * frames / t1:.2f} frames/s), B's outcomes {acc_b['outcomes']}, waves "
            f"(units, predicted s) {packs}, {bytes1} bytes equal the plain resize, "
            f"no alert fired")

        objects = {pvs: b.store.object_path(b.store.lookup(u["plan"]).object["sha256"])
                   for pvs, u in units1.items()}

        # 2. pin one plan through the tool; a seventh plan's completion
        # runs the service's own budget pass, which evicts LRU and keeps it
        pinned_pvs = "P2STR01_SRC101_HRC001"
        pinned = units1[pinned_pvs]["plan"]
        _tool(["store-admin", "--store", b.store.root, "pin", pinned, "--label", "phase15"],
              timeout=120)
        require(pinned in b.store.pins(), "control: store-admin pin did not pin")
        before = b.store.stats()["bytes"]
        # the hook checks the budget at most once a min_interval_s: wait
        # out the checks that step 1's completions made
        time.sleep(max(0.0, done1 + b.pressure.min_interval_s + 1.0 - time.monotonic()))
        t0 = time.perf_counter()
        acc = _post_control(url_b, _control_body(["SRC107"], tenant="lab-b"))
        doc, _ = _wait_done(url_b, acc["request"], 300)
        t2 = time.perf_counter() - t0
        require(doc["state"] == "done", f"control: SRC107 {acc['outcomes']} {doc['state']}")
        _check_artifacts(dev, b, url_b, doc["units"], shas)
        # the pass runs just after the request reads as done, and drops a
        # manifest before its object: wait for both
        deadline = time.monotonic() + 30.0
        evicted: list = []
        while not evicted and time.monotonic() < deadline:
            time.sleep(0.02)
            evicted = sorted(pvs for pvs, u in units1.items()
                             if b.store.lookup(u["plan"]) is None
                             and not os.path.exists(objects[pvs]))
        gcs = [e for e in serve_tm.EVENTS.records()
               if e.get("event") == "serve_gc" and e.get("objects_evicted")]
        after = b.store.stats()["bytes"]
        require(evicted and gcs, f"control: the completion hook evicted nothing: {gcs}")
        require(after <= CONTROL_BUDGET, f"control: {after} bytes kept over {CONTROL_BUDGET}")
        require(b.store.lookup(pinned) is not None and pinned_pvs not in evicted
                and all(e["pins_honored"] >= 1 for e in gcs),
                f"control: the pinned plan was not honored: {gcs}")
        freed = sum(e["bytes_freed"] for e in gcs)
        steps["2_pressure"] = {"frames_per_s": frames / t2, "seconds": t2, "evicted_bytes": freed,
                               "evicted_units": evicted, "kept_bytes": after,
                               "passes": len(gcs)}
        log(f"phase 15 (b) 2: pinned {pinned_pvs}; SRC107 in {t2:.3f} s ({frames / t2:.2f} "
            f"frames/s); the completion hook's budget pass ({CONTROL_BUDGET} B, {len(gcs)} "
            f"pass(es)) evicted {freed} bytes ({evicted}), {before} + one unit -> {after} "
            f"bytes kept, pins honored {[e['pins_honored'] for e in gcs]}")

        # 3. an evicted plan POSTed again: recomputed, same bytes, regret
        redo_pvs = evicted[0]
        t0 = time.perf_counter()
        acc = _post_control(url_a, _control_body([redo_pvs.split("_")[1]]))
        doc, _ = _wait_done(url_a, acc["request"], 300)
        t3 = time.perf_counter() - t0
        require(doc["state"] == "done", f"control: re-POST {acc['outcomes']} {doc['state']}")
        want3 = launches_want(resize_frames_fused=3 * 8, siti_frames_fused_batch=8)
        require(dict(ck.LAUNCHES) == want3,
                f"control: the evicted plan was not recomputed: {dict(ck.LAUNCHES)} != {want3}")
        _check_artifacts(dev, a, url_a, doc["units"], shas)
        heat_doc = json.loads(_tool(["store-heat", "report", b.store.root, "--json"],
                                    timeout=120).stdout)
        regrets = heat_doc["totals"]["regrets"]
        require(regrets >= 1, f"control: store-heat reports {regrets} regrets")
        steps["3_regret"] = {"frames_per_s": frames / t3, "seconds": t3, "regrets": regrets,
                             "outcomes": acc["outcomes"]}
        log(f"phase 15 (b) 3: {redo_pvs} re-POSTed after its eviction: recomputed in "
            f"{t3:.3f} s ({frames / t3:.2f} frames/s), bytes equal its first run; tools "
            f"store-heat: {regrets} regret(s), {heat_doc['totals']['evictions']} evictions")

        # 4. 8 units: refused at POST, the queue untouched
        jobs_dir = os.path.join(root, "queue", "jobs")
        depth0 = len(os.listdir(jobs_dir))
        big = _control_body([f"SRC2{i:02d}" for i in range(8)])
        code, raw = _http(url_b + "/v1/requests", big)
        refusal = json.loads(raw)
        require(code == 429 and refusal.get("reason") == "request_budget"
                and refusal.get("budget_s") == admission_s
                and abs(refusal.get("predicted_s", 0) - 8 * unit_s) < 2e-3
                and len(refusal.get("heaviest", [])) == 5 and refusal.get("retryable") is False,
                f"control: 8-unit POST -> {code} {refusal}")
        require(len(os.listdir(jobs_dir)) == depth0, "control: the refused request queued work")
        steps["4_admission"] = {"status": code, "body": refusal}
        log(f"phase 15 (b) 4: 8-unit POST -> {code}: predicted {refusal['predicted_s']} s "
            f"against {refusal['budget_s']:.3f} s, heaviest {refusal['heaviest'][:2]}..., "
            f"queue depth {depth0} unchanged")

        # 5. A stops with a request outstanding; B's tick adopts it
        a.scheduler.stop()
        a._poll_stop.set()
        a._poll_thread.join(timeout=10.0)
        t0 = time.perf_counter()
        orphan = a.submit(_control_body(["SRC108", "SRC109"]))
        a.queue.close()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            doc = b.request_status(orphan["request"])
            if doc is not None and doc["state"] == "done":
                break
            time.sleep(0.05)
        t5 = time.perf_counter() - t0
        doc = b.request_status(orphan["request"])
        require(doc is not None and doc["state"] == "done",
                f"control: B did not adopt A's orphan: {doc and doc['state']}")
        with open(os.path.join(root, "requests", orphan["request"] + ".json")) as f:
            owner = json.load(f)["owner"]["replica"]
        require(owner == "w-b", f"control: the orphan's owner is {owner}")
        _check_artifacts(dev, b, url_b, doc["units"], shas)
        steps["5_orphan"] = {"frames_per_s": 2 * frames / t5, "seconds": t5, "owner": owner}
        log(f"phase 15 (b) 5: A stopped with {orphan['request']} outstanding; B adopted and "
            f"finished it in {t5:.3f} s ({2 * frames / t5:.2f} frames/s), owner {owner}")

        # 6. the fleet routes on B
        b._control_tick(force=True)
        code, raw = _http(url_b + "/fleet")
        fleet_doc = json.loads(raw)
        reps = {r["replica"]: r.get("status") for r in fleet_doc["replicas"]}
        require(code == 200 and set(reps) == {"w-a", "w-b"} and reps["w-b"] == "ok",
                f"control: /fleet -> {code} {reps}")
        code, raw = _http(url_b + "/fleet/scale-signal")
        signal = json.loads(raw)
        require(code == 200 and signal.get("replicas_desired", 0) >= 1,
                f"control: /fleet/scale-signal -> {code} {signal}")
        code, raw = _http(url_b + "/fleet/alerts")
        alerts_doc = json.loads(raw)
        folded = serve_alerts.fold(serve_alerts.read_journals(serve_alerts.alerts_dir(root)))
        firing = sorted(k for k, v in folded.items() if v.get("state") == "firing")
        resolved = sorted(k for k, v in folded.items() if v.get("state") == "resolved")
        require(code == 200 and sorted(x["alert"] for x in alerts_doc["active"]) == firing
                and sorted(x["alert"] for x in alerts_doc["resolved"]) == resolved,
                f"control: /fleet/alerts {alerts_doc} != fold {folded}")
        alert_set = {k: v.get("state") for k, v in folded.items()}
        log(f"phase 15 (b) 6: /fleet replicas {reps}, scale signal "
            f"{signal.get('replicas_current')} -> {signal.get('replicas_desired')} "
            f"{signal.get('reasons')}, alerts {alert_set}")

        # 7. --cost-calibrate: each execution settled once, then B alone
        # settles enough units for its maintenance tick to refit the scale
        path_ratios = a.cost_ledger.ratios() + b.cost_ledger.ratios()
        require(len(path_ratios) == 10,
                f"control: {len(path_ratios)} observed/predicted ratios for 10 executions")
        require(serve_cost.calibration()["n"] == 0, "control: calibrated before step 7")
        need = serve_cost.CALIBRATION_MIN_SAMPLES - len(b.cost_ledger.ratios())
        n_req = -(-need // 4)
        t0 = time.perf_counter()
        accs = [_post_control(url_b, _control_body([f"SRC3{4 * i + j:02d}" for j in range(4)],
                                                   tenant="lab-c"))
                for i in range(n_req)]
        cal_ratios = []
        for acc in accs:
            doc, _ = _wait_done(url_b, acc["request"], 300)
            require(doc["state"] == "done", f"control: calibration request {doc['state']}")
            for u in doc["units"].values():
                rec = b.queue.by_plan(u["plan"])
                require(rec is not None and rec.claimed_at and rec.done_at and rec.cost_s > 0,
                        f"control: the record of {u['plan']} has no timing")
                cal_ratios.append((rec.done_at - rec.claimed_at) / rec.cost_s)
        t7 = time.perf_counter() - t0
        deadline = time.monotonic() + 30.0
        while serve_cost.calibration()["n"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        cal = serve_cost.calibration()
        require(cal["n"] >= serve_cost.CALIBRATION_MIN_SAMPLES,
                f"control: the service's --cost-calibrate did not refit: {cal}")
        steps["7_calibration"] = {"frames_per_s": 4 * n_req * frames / t7, "seconds": t7,
                                  "units": 4 * n_req}
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        path_s = time.perf_counter() - t_path
    finally:
        for svc in svcs.values():
            svc.stop()
        serve_cost.reset_calibration()

    executions = 10 + 4 * n_req
    want = launches_want(resize_frames_fused=3 * executions, siti_frames_fused_batch=executions)
    require(launches == want, f"control: launches {launches} != {want}")
    pct = {f"p{int(q * 100)}": serve_fleet.percentile_exact(path_ratios, q)
           for q in (0.1, 0.5, 0.9)}
    cal_pct = {f"p{int(q * 100)}": serve_fleet.percentile_exact(cal_ratios, q)
               for q in (0.1, 0.5, 0.9)}
    log(f"phase 15 (b) 7: {4 * n_req} more units on B in {t7:.3f} s "
        f"({4 * n_req * frames / t7:.2f} frames/s); cost ledger observed/predicted over "
        f"steps 1-5's 10 executions {pct}, over step 7's units {cal_pct}; the service's "
        f"--cost-calibrate refit the scale to {cal['scale']} from {cal['n']} ratios (clamped "
        f"to {serve_cost.CALIBRATION_SCALE_RANGE}; predicted {unit_s:.4f} s a unit from the "
        f"reference's CPU-fitted base); launches {launches}; the path took {path_s:.1f} s")
    return {"launches": launches, "steps": steps, "unit_predicted_s": unit_s,
            "admission_budget_s": admission_s, "wave_budget_s": wave_budget_s,
            "cost_ratio_percentiles": pct, "cost_ratios": path_ratios,
            "calibration_ratio_percentiles": cal_pct, "calibration": cal,
            "alerts": alert_set, "evicted_bytes": steps["2_pressure"]["evicted_bytes"],
            "path_s": path_s}


# ---------------------------------------------------------------------------
# phase 16: the serve fleet's proof harnesses
# ---------------------------------------------------------------------------

def _tool_json(args: list, timeout: float) -> tuple:
    """One tool process (`_tool`): (its last stdout line as JSON, its wall
    seconds)."""
    t0 = time.perf_counter()
    proc = _tool(args, timeout)
    return json.loads(proc.stdout.strip().splitlines()[-1]), time.perf_counter() - t0


def harness_soak(dev, root: str, smi: str) -> dict:
    """Phase 16 (a): `tools serve-soak --executor wave` in this process on
    the card, at the tool's defaults."""
    out = root + ".json"
    ck.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = serve_soak.main(["--executor", "wave", "--device", str(dev), "--root", root,
                              "--out", out])
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
    finally:
        meshobs.detach_journal()
    wall = time.perf_counter() - t0
    with open(out) as f:
        report = json.load(f)
    require(rc == 0 and report["ok"], f"harness soak: rc {rc}, {report['failures']}")
    require(report["jobs_planned"] == report["unique_plans"],
            f"harness soak: {report['jobs_planned']} executions, "
            f"{report['unique_plans']} plans")
    records = [r for r in meshobs.read_journals(meshobs.mesh_dir(root)) if r.get("kind") == "wave"]
    blocks = len(records)
    for r in records:
        require(r["valid"] + r["pad_tail"] + r["pad_exhausted"] + r["pad_mesh"]
                == r["dispatched"], f"harness soak: wave record {r}")
    # the wave executor's 8-frame units: one block each on the pinned card
    require(blocks == report["unique_plans"], f"harness soak: {blocks} wave blocks")
    want = launches_want(resize_frames_fused=3 * blocks, siti_frames_fused_batch=blocks)
    require(launches == want, f"harness soak: launches {launches} != {want}")
    # one served artifact against the same unit (its queue record's) on
    # the CPU route
    rec = min(serve_chaos._load_records(root).values(), key=lambda r: r["job"])
    unit = rec["unit"]
    pvs = unit["pvs_id"]
    store = ArtifactStore(os.path.join(root, "store"))
    with open(store.object_path(store.lookup(rec["planHash"]).object["sha256"]), "rb") as f:
        served = f.read()
    ref_path = os.path.join(os.path.dirname(root), "cpu_ref.bin")
    DeviceWaveExecutor(device="cpu").run_batch(
        [serve_api.Unit(unit["database"], unit["src"], unit["hrc"], unit["params"])],
        [ref_path])
    with open(ref_path, "rb") as f:
        require(served == f.read(), f"harness soak: {pvs}'s artifact differs from the CPU route")
    phases = report["latency_phases"]
    log(f"phase 16 (a): serve-soak --executor wave on {dev}: {report['requests']} requests, "
        f"{report['units_total']} units, {report['unique_plans']} plans, "
        f"{report['jobs_planned']} executions, {blocks} wave blocks, launches {launches}; "
        f"{pvs} equal to the CPU route ({len(served)} bytes); cold wall "
        f"{report['cold_wall_s']} s, warm p50 {report['warm_request_ms']['p50']} ms; "
        f"queue-wait {phases['queue_wait_ms']}, execution {phases['execution_ms']}, e2e "
        f"{phases['e2e_ms']} ms; the soak took {wall:.1f} s ({smi})")
    return {"launches": launches, "blocks": blocks, "seconds": wall,
            "report": {k: report[k] for k in ("requests", "units_total", "unique_plans",
                                              "jobs_planned", "cold_wall_s",
                                              "warm_request_ms", "latency_phases")}}


def harness_pack(root: str, smi: str) -> dict:
    """Phase 16 (b): `tools serve-soak --pack-bench` as a process (its e2e
    tail gate is wall clock: a process of its own keeps (a)'s in-process
    service state out of it)."""
    report, wall = _tool_json(["serve-soak", "--pack-bench", "--root", root], timeout=300)
    modes = report["modes"]
    log(f"phase 16 (b): pack-bench: predicted-seconds cv a wave, count "
        f"{modes['count']['wave_pred_cv']} ({modes['count']['waves']} waves) vs cost-aware "
        f"{modes['cost']['wave_pred_cv']} ({modes['cost']['waves']} waves); e2e p95 "
        f"{modes['count']['e2e_p95_s']} s vs {modes['cost']['e2e_p95_s']} s; {wall:.1f} s ({smi})")
    require(report["ok"], f"pack-bench: {report['failures']}")
    return {"modes": modes, "seconds": wall}


def stolen_request(root: str) -> str:
    """A done request of a chaos root one of whose units was stolen."""
    spans = serve_spans.read_journals(os.path.join(root, "queue", "spans"))
    stolen = {s["job"] for s in spans if s.get("phase") == "steal"}
    docs = serve_chaos._load_requests(root)
    for job, rec in sorted(serve_chaos._load_records(root).items()):
        if job in stolen:
            for req in rec.get("requests") or ():
                if docs.get(req, {}).get("state") == "done":
                    return req
    raise SmokeFailure(f"chaos: no done request with a stolen unit ({len(stolen)} steals)")


def harness_chaos(base: str, smi: str) -> dict:
    """Phase 16 (c): `tools serve-chaos --corrupt-corpus` and `--self-test`
    as processes, at the tool's defaults."""
    root = os.path.join(base, "chaos")
    report, wall = _tool_json(["serve-chaos", "--corrupt-corpus", "--root", root], timeout=400)
    require(report["ok"] and report["failures"] == [], f"chaos: {report['failures']}")
    steals = report["fleet"]["spans"]["by_phase"].get("steal", 0)
    log(f"phase 16 (c): serve-chaos --corrupt-corpus in {wall:.1f} s: {report['requests']} "
        f"requests, {report['units_total']} units, {report['unique_plans']} plans through "
        f"{report['kills_done']} kills and {report['stops']} stop; lease steals {steals} "
        f"(journal; /metrics of the survivors {report['counters']}), poisoned digests "
        f"{report['corrupt_corpus']}, warm p50 during churn "
        f"{report['warm_request_ms']['p50']} ms, churn {report['churn_throughput_units_per_s']} "
        f"units/s; each replica's seconds to /healthz {report['replica_healthz_s']} ({smi})")
    self_root = os.path.join(base, "chaos_self")
    log(f"phase 16 (c): host before the self-test: {host_load()}")
    self_test, self_wall = _tool_json(["serve-chaos", "--self-test", "--root", self_root],
                                      timeout=300)
    require(all(self_test["classes"].values()), f"chaos self-test: {self_test}")
    log(f"phase 16 (c): serve-chaos --self-test in {self_wall:.1f} s: classes "
        f"{self_test['classes']}, {len(self_test['violations'])} violations")
    return {"root": root, "seconds": wall, "self_test_seconds": self_wall, "steals": steals,
            "corrupt_corpus": report["corrupt_corpus"], "warm_request_ms":
            report["warm_request_ms"], "replica_healthz_s": report["replica_healthz_s"]}


def harness_trace(root: str, req: str, chrome: str, label: str) -> int:
    """Phase 16 (d): `tools trace show` on one request as a process; the
    Chrome export must hold events. Returns the event count."""
    proc = _tool(["trace", "show", req, "--root", root, "--chrome", chrome], timeout=120)
    require("trace: COMPLETE" in proc.stdout, f"trace {label}: {proc.stdout[-2000:]}")
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    require(len(events) > 0, f"trace {label}: no Chrome events")
    return len(events)


def harness_steadiness(rounds: int, checkouts: list, smi: str) -> dict:
    """`--steadiness N`: phase 16's wall-clock gates N times over each
    checkout in turn (see the module doc). Returns the failures by
    checkout and gate."""
    failed = {os.path.relpath(c, ROOT): {"pack": 0, "self_test": 0, "chaos": 0}
              for c in checkouts}
    with ram_root("steadiness") as base:
        _steady_rounds(rounds, checkouts, base, failed, smi)
    log(f"steadiness: failures over {rounds} rounds (chaos every 4th) on "
        f"{mount_of(RAM_BASE)[1]} at {RAM_BASE} {failed}")
    return failed


def _steady_rounds(rounds: int, checkouts: list, base: str, failed: dict, smi: str) -> None:
    for i in range(rounds):
        for c in checkouts:
            root = os.path.join(base, f"steady{i}")
            shutil.rmtree(root, ignore_errors=True)
            gates = failed[os.path.relpath(c, ROOT)]
            try:
                proc = _tool(["serve-soak", "--pack-bench", "--root", root + "/pack"], 300,
                             cwd=c, check=False)
                modes = json.loads(proc.stdout.strip().splitlines()[-1])["modes"]
                gates["pack"] += proc.returncode != 0
                line = (f"pack e2e p95 count {modes['count']['e2e_p95_s']} s, cost "
                        f"{modes['cost']['e2e_p95_s']} s (rc {proc.returncode})")
                proc = _tool(["serve-chaos", "--self-test", "--root", root + "/self"], 300,
                             cwd=c, check=False)
                gates["self_test"] += proc.returncode != 0
                missed = [ln.split("FAILED: ", 1)[1] for ln in proc.stderr.splitlines()
                          if "clean pass FAILED" in ln]
                line += f"; self-test rc {proc.returncode}{': ' + missed[0] if missed else ''}"
                if i % 4 == 0:
                    proc = _tool(["serve-chaos", "--corrupt-corpus", "--root", root + "/chaos"],
                                 400, cwd=c, check=False)
                    report = json.loads([ln for ln in proc.stdout.splitlines()
                                         if ln.startswith("{")][-1])
                    gates["chaos"] += proc.returncode != 0
                    line += (f"; chaos warm p50 {report['warm_request_ms']['p50']} ms, p90 "
                             f"{report['warm_request_ms']['p90']} ms (rc {proc.returncode})")
            finally:
                shutil.rmtree(root, ignore_errors=True)
            log(f"steadiness {i} {os.path.relpath(c, ROOT)}: {line} ({smi})")


def run_harness(dev, smi: str) -> dict:
    """Phase 16: the serve fleet's proof harnesses (see the module doc)."""
    with ram_root("phase 16") as base:
        soak_root = os.path.join(base, "soak")
        soak = harness_soak(dev, soak_root, smi)
        pack = harness_pack(os.path.join(base, "pack"), smi)
        chaos = harness_chaos(base, smi)
        # the first request of the cold pass (the warm pass's answered at
        # submit and left no span to trace)
        soak_req = min(serve_chaos._load_requests(soak_root).values(),
                       key=lambda d: d["created_at"])["request"]
        steal_req = stolen_request(chaos["root"])
        events = {"soak": harness_trace(soak_root, soak_req, os.path.join(base, "soak_trace.json"),
                                        "soak"),
                  "stolen": harness_trace(chaos["root"], steal_req,
                                          os.path.join(base, "steal_trace.json"), "stolen")}
        log(f"phase 16 (d): trace show: COMPLETE for {soak_req} (soak) and {steal_req} (a "
            f"stolen unit); Chrome events {events}")
        return {"soak": soak, "pack": pack, "chaos": chaos, "trace_events": events,
                "launches": soak["launches"]}


# ---------------------------------------------------------------------------
# phase 17: the port's own gates
# ---------------------------------------------------------------------------

# phase 11's request A cut to one HRC: 2 units of SERVE_GEO
GATE_REQUEST = {"tenant": "lab-a", "database": "P2STR01", "srcs": ["SRC001", "SRC002"],
                "hrcs": ["HRC001"], "params": SERVE_GEO}
GATE_PLANS = 2
GATE_ENV = ("PC_LOCK_DEBUG", "PC_PLAN_DEBUG")


def gate_lint(smi: str) -> dict:
    """Phase 17 (a): the port's `tools chain-lint` as a process, bare (the
    port's package and this script, on the port's registries and
    baseline); a finding, a stale entry or the timeout fails the run."""
    t0 = time.perf_counter()
    proc = _tool(["chain-lint"], timeout=300)
    wall = time.perf_counter() - t0
    summary = proc.stdout.strip().splitlines()[-1]
    require(summary.startswith("chain-lint: OK"), f"chain-lint: {proc.stdout[-2000:]}")
    log(f"phase 17 (a): {summary}; {wall:.2f} s ({smi})")
    return {"summary": summary, "seconds": wall}


def gate_recorders(dev, workdir: str, smi: str) -> dict:
    """Phase 17 (b): the port's lock-order and plan-purity recorders over
    phase 11's service on the card, at GATE_PLANS units. PC_LOCK_DEBUG and
    PC_PLAN_DEBUG are set before the service is built (make_lock decides
    at construction) and restored after, so no later timing runs on
    tracked locks."""
    root = os.path.join(workdir, "gates")
    shutil.rmtree(root, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in GATE_ENV}
    os.environ.update(dict.fromkeys(GATE_ENV, "1"))
    try:
        lockdebug.reset()
        plandebug.reset()
        t0 = time.perf_counter()
        svc = ChainServeService(root=root, port=0, executor="wave", workers=1,
                                wave_width=4, device=dev)
        try:
            svc.start()
            url = svc.server.url
            ck.reset_launches()
            code, body = _http(url + "/v1/requests", GATE_REQUEST)
            require(code == 202, f"gates: POST -> {code} {body[:300]!r}")
            doc, _ = _wait_done(url, json.loads(body)["request"], 600)
            torch.cuda.synchronize()
            launches = dict(ck.LAUNCHES)
            require(doc["state"] == "done", f"gates: request {doc['state']} {doc.get('error')}")
            blocks = GATE_PLANS * -(-SERVE_GEO["frames"] // SERVE_BLOCK)
            want = launches_want(resize_frames_fused=3 * blocks, siti_frames_fused_batch=blocks)
            require(launches == want, f"gates: launches {launches} != {want}")
            code, body = _http(url + "/v1/requests", GATE_REQUEST)
            require(code == 202 and json.loads(body)["state"] == "done",
                    f"gates: warm re-POST -> {code} {body[:300]!r}")
            for pvs, u in sorted(doc["units"].items()):
                code, digest, _ = _http_sha256(url + u["artifact"])
                _, src, hrc = pvs.split("_")
                unit = serve_api.Unit("P2STR01", src, hrc, dict(SERVE_GEO))
                require(code == 200 and digest == serve_reference(dev, svc.executor, unit),
                        f"gates: {pvs}: artifact differs from the plain route")
        finally:
            svc.stop()
            meshobs.detach_journal()
        wall = time.perf_counter() - t0
        locks = lockdebug.check()
        plans = plandebug.check()
        require(locks["edges"] > 0, f"gates: the lock recorder saw no edge ({locks})")
        require(plans["plans"] == GATE_PLANS, f"gates: {plans['plans']} plans recorded, "
                f"not {GATE_PLANS}")
        log(f"phase 17 (b): lock-order recorder: {locks['edges']} edges over {locks['nodes']} "
            f"locks, acyclic; plan-purity recorder: {plans['plans']} plan(s) committed, no "
            f"same-plan/different-bytes; {GATE_PLANS} units, launches {launches}, "
            f"{wall:.2f} s ({smi})")
        return {"launches": launches, "lock_edges": locks["edges"],
                "lock_nodes": locks["nodes"], "plans": plans["plans"], "seconds": wall}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        lockdebug.reset()
        plandebug.reset()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def run_gates(dev, workdir: str, smi: str) -> dict:
    """Phase 17: the port's own gates (see the module doc)."""
    return {"lint": gate_lint(smi), "recorders": gate_recorders(dev, workdir, smi)}


# ---------------------------------------------------------------------------
# phase 18: the media boundary and p03's file-level short path
# ---------------------------------------------------------------------------

MEDIA_DB = "P2STR18"
MEDIA_FPS, MEDIA_FRAMES = 60, 120       # SRC000: 2 s of a 10 s PVS at 60 fps (the cut)
MEDIA_FPS_10, MEDIA_FRAMES_10 = 32, 64  # SRC001: 10-bit, 2 s at 32 fps
MEDIA_SAMPLE_RATE = 48000
# a short test at published widths: 1080p60 segments onto the pc 3840x2160
# canvas; HRC001 has a stall between its two quality events (two 1 s
# segments, of which the short path renders the first, as the JAX package
# does), HRC000 one 2 s segment
MEDIA_YAML = """\
databaseId: {db_id}
syntaxVersion: 6
type: short
qualityLevelList:
  Q0: {{index: 0, videoCodec: h264, videoBitrate: 6000, width: 1920, height: 1080, fps: original}}
codingList:
  VC01: {{type: video, encoder: libx264, passes: 1, iFrameInterval: 2, preset: medium}}
srcList:
  SRC000: SRC000.avi
  SRC001: SRC001.avi
hrcList:
  HRC000: {{videoCodingId: VC01, eventList: [[Q0, 2]]}}
  HRC001: {{videoCodingId: VC01, eventList: [[Q0, 1], [stall, 0.5], [Q0, 1]]}}
  HRC002: {{videoCodingId: VC01, eventList: [[Q0, 1], [freeze, 0.25], [freeze, 0.5]]}}
pvsList:
  - {db_id}_SRC000_HRC000
  - {db_id}_SRC000_HRC001
  - {db_id}_SRC000_HRC002
  - {db_id}_SRC001_HRC000
postProcessingList:
  - {{type: pc, displayWidth: 3840, displayHeight: 2160, codingWidth: 3840, codingHeight: 2160}}
"""
# the same SRC as a long test: two 1 s FFV1+FLAC segments onto the pc
# 3840x2160 canvas at 60 fps, with the SRC's audio, a 0.5 s stall at the
# join (120 frames, then 150 stalled)
LONG_DB = "P2LTR18"
LONG_YAML = """\
databaseId: {db_id}
syntaxVersion: 6
type: long
segmentDuration: 1
qualityLevelList:
  Q0: {{index: 0, videoCodec: h264, videoBitrate: 6000, width: 1920, height: 1080, fps: original, audioCodec: aac, audioBitrate: 128}}
codingList:
  VC01: {{type: video, encoder: libx264, passes: 1, iFrameInterval: 2, preset: medium}}
  AC01: {{type: audio, encoder: aac}}
srcList:
  SRC000: SRC000.avi
hrcList:
  HRC000: {{videoCodingId: VC01, audioCodingId: AC01, eventList: [[Q0, 1], [stall, 0.5], [Q0, 1]]}}
pvsList:
  - {db_id}_SRC000_HRC000
postProcessingList:
  - {{type: pc, displayWidth: 3840, displayHeight: 2160, codingWidth: 3840, codingHeight: 2160}}
"""
MEDIA_CODECS = ("h264", "hevc", "vp9", "av1", "aac", "flac")
P04_ENCODERS = ("rawvideo", "v210", "prores_ks")  # PC UYVY422, PC 10-bit, the preview
#: p01's video encoders (in the order (h) picks one) and audio encoders
P01_ENCODERS = ("libvpx-vp9", "libx265", "libaom-av1", "libx264")
P01_AUDIO = ("libopus", "aac")
#: the bitstream filters p02's exact frame sizes take (VP9 goes through IVF)
P02_FILTERS = ("h264_mp4toannexb", "hevc_mp4toannexb")
FIXTURES = os.path.join(ROOT, "processing_chain_tpu_torch", "assets", "media")


def media_binding() -> dict:
    """(a): the libav io/medialib bound, and the committed fixtures decoded
    through the port's VideoReader against the JAX reader's record."""
    b = medialib.binding()
    log(f"media boundary: {medialib.version()}")
    log(f"media boundary: {len(b['checks'])} layout entries passed their round trips: "
        f"{' '.join(b['checks'])}")
    decoders = medialib.codecs(MEDIA_CODECS)
    log(f"media boundary decoders: {json.dumps(decoders)}; absent: "
        f"{[c for c, ok in decoders.items() if not ok] or 'none'}")
    require(decoders["h264"], "the bound libav has no h264 decoder")
    encoders = medialib.codecs(P04_ENCODERS, encoder=True)
    log(f"media boundary encoders p04 needs: {json.dumps(encoders)}")
    p01_encoders = medialib.codecs(P01_ENCODERS + P01_AUDIO, encoder=True)
    twopass = medialib.twopass()
    bsf_entries = [c for c in b["checks"] if c.startswith("AVBSFContext.")]
    filters = medialib.bitstream_filters(P02_FILTERS)
    log(f"media boundary encoders p01 needs: {json.dumps(p01_encoders)}; two-pass round trips "
        f"at load: {json.dumps(twopass)}; bitstream filter entries "
        f"{bsf_entries or 'not checked (no null or h264_mp4toannexb filter)'}, filters p02 "
        f"needs: {json.dumps(filters)}")
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        record = json.load(f)
    prober = io_probe.LibavProber()
    out = {}
    for name, want in sorted(record.items()):
        codec = want["probe"][0]["codec_name"]
        if not decoders.get(codec, False):
            log(f"fixture {name}: NOT decoded, this libav has no {codec} decoder")
            out[name] = {"decoded": False}
            continue
        path = os.path.join(FIXTURES, name)
        with VideoReader(path) as r:
            stacks, _pts = r.read_all()
        md5 = [[hashlib.md5(np.ascontiguousarray(p[k]).tobytes()).hexdigest() for p in stacks]
               for k in range(len(_pts))]
        require(md5 == want["md5"], f"fixture {name}: decoded planes differ from the record")
        info = prober.src_info(path)
        from fractions import Fraction
        got = {"width": info["width"], "height": info["height"], "pix_fmt": info["pix_fmt"],
               "r_frame_rate": Fraction(info["r_frame_rate"]), "frames": len(md5)}
        ref = {k: want[k] for k in ("width", "height", "pix_fmt", "frames")}
        ref["r_frame_rate"] = Fraction(want["r_frame_rate"])
        require(got == ref, f"fixture {name}: probe {got} != {ref}")
        require(abs(info["video_duration"] - want["duration"]) <= 1e-3,
                f"fixture {name}: duration {info['video_duration']} != {want['duration']}")
        full = {s["index"]: s for s in medialib.probe(path)["streams"]}
        differ = {f"{s['index']}.{k}": [v, full.get(s["index"], {}).get(k)]
                  for s in want["probe"] for k, v in s.items()
                  if json.loads(json.dumps(full.get(s["index"], {}).get(k))) != v}
        log(f"fixture {name}: {len(md5)} frames equal to the record (md5 of each plane), "
            f"probe fields equal; other fields that differ from FFmpeg 5.1's: "
            f"{json.dumps(differ) if differ else 'none'}")
        out[name] = {"decoded": True, "frames": len(md5), "probe_differs": differ}
    return {"version": medialib.version(), "checks": len(b["checks"]),
            "decoders": decoders, "encoders": encoders, "p01_encoders": p01_encoders,
            "twopass": twopass, "bsf_entries": bsf_entries, "filters": filters,
            "fixtures": out}


def media_tone(n: int, seed: int) -> np.ndarray:
    """n stereo int16 samples: two seeded tones."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(200, 900, 2)
    t = np.arange(n)[:, None] / MEDIA_SAMPLE_RATE
    return (np.sin(2 * np.pi * f[None, :] * t) * 9000).astype(np.int16)


def write_media(path: str, chunks, fps: int, pix_fmt: str, audio) -> None:
    """FFV1 (+FLAC) AVI of host chunks, written through the port's
    VideoWriter, then moved to `path` whatever its extension (the demuxer
    probes the bytes, not the name)."""
    tmp = path + ".tmp.avi"
    extra = dict(audio_codec="flac", sample_rate=MEDIA_SAMPLE_RATE, channels=2) \
        if audio is not None else {}
    with VideoWriter(tmp, "ffv1", SRC_W, SRC_H, pix_fmt, (fps, 1), threads=1,
                     opts="level=3:slicecrc=1:pc_fp_workers=6", **extra) as w:
        if audio is not None:
            w.write_audio(audio)
        for c in chunks:
            w.write_batch(*c)
    os.replace(tmp, path)


class StageProcess:
    """`python -m processing_chain_tpu_torch <stage>` (p03 or p04) as a
    process on cuda:0, its output in files beside `log_dir`. `finish()`
    waits for it and returns (its summary, wall seconds); `stop()` kills it
    where it still runs (the smoke leaves no process behind)."""

    def __init__(self, stage: str, yaml_path: str, pvs_ids: list, *extra,
                 log_dir: str, env: dict = None) -> None:
        # -p 1: one job at a time, so the stage's pool-aware writeback
        # default gives the one render every spare core (--ffv1-workers
        # unpinned)
        cmd = [sys.executable, "-m", "processing_chain_tpu_torch", stage, "-c", yaml_path,
               "-p", "1", "--filter-pvs", "|".join(pvs_ids), *extra]
        self.stage = stage
        self.err_path = os.path.join(log_dir, f"{stage}-{os.getpid()}-{time.monotonic_ns()}.err")
        self.t0 = time.perf_counter()
        # chainlint: disable=atomic-write (the child's stderr stream, read back once it exits; a truncated file fails that run's checks)
        with open(self.err_path, "w") as err:
            # chainlint: disable=subprocess-hygiene (the stage CLI as a process that runs beside the smoke's checks; finish() waits with a timeout and checks its exit code and log, stop() kills it)
            self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err,
                                         text=True, env=None if env is None else
                                         {**os.environ, **env})

    def finish(self, timeout: float = 600) -> tuple:
        summaries, wall = self.finish_stages([self.stage], timeout)
        return summaries[self.stage], wall

    def finish_stages(self, stages: list, timeout: float = 600) -> tuple:
        """Wait for the process: ({stage: its summary line} for each of
        `stages` (p00 logs p01's, p03's and p04's), wall seconds)."""
        rc = self.proc.wait(timeout=timeout)
        wall = time.perf_counter() - self.t0
        with open(self.err_path) as f:
            err = f.read()
        require(rc == 0, f"{self.stage} CLI exit {rc}: {err[-3000:]}")
        # the process's seconds before its stage started, as the CLI logs them
        start = [ln for ln in err.splitlines() if f"{self.stage} start-up: " in ln]
        startup = json.loads(start[0].split(f"{self.stage} start-up: ", 1)[1]) if start else None
        out = {}
        for stage in stages:
            lines = [ln for ln in err.splitlines() if f"{stage} summary: " in ln]
            require(len(lines) == 1, f"{self.stage} CLI printed {len(lines)} {stage} summaries: "
                    f"{err[-2000:]}")
            out[stage] = json.loads(lines[0].split(f"{stage} summary: ", 1)[1])
            out[stage]["startup"] = startup
        return out, wall

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def stage_cli(stage: str, yaml_path: str, pvs_ids: list, *extra, log_dir: str) -> tuple:
    """A stage CLI process run to its end: (its summary, wall seconds)."""
    run = StageProcess(stage, yaml_path, pvs_ids, *extra, log_dir=log_dir)
    try:
        return run.finish()
    finally:
        run.stop()


class FrameTaker:
    """A decoded file's chunks, taken `t` frames at a time whatever the
    file's own chunking (a long test's segments give chunks of their own
    lengths)."""

    def __init__(self, chunks) -> None:
        self._it = iter(chunks)
        self._buf = None

    def take(self, t: int) -> list:
        parts = []
        while t > 0:
            if self._buf is None or self._buf[0].shape[0] == 0:
                self._buf = [np.array(p) for p in next(self._it)]
            k = min(t, self._buf[0].shape[0])
            parts.append([p[:k] for p in self._buf])
            self._buf = [p[k:] for p in self._buf]
            t -= k
        return [np.concatenate([q[i] for q in parts]) for i in range(len(parts[0]))]

    def exhausted(self) -> bool:
        if self._buf is not None and self._buf[0].shape[0]:
            return False
        return next(self._it, None) is None


def decoded_chunks(path: str):
    """A file's decoded chunks (host planes), the reader closed after."""
    with VideoReader(path) as r:
        yield from r.iter_chunks(avpvs.CHUNK)


def check_render(dev, src_chunks, avpvs_path: str, pix_fmt: str, frames: int) -> dict:
    """An AVPVS against the plain route on the card over its source chunks
    (a short test's decoded segment; a long test's segments on the canvas
    time grid, in order): `frames` frames, u8 planes bit-exact (10-bit
    within a code value), its .siti.csv within 1e-3 (1e-2) of
    si/ti_frames_plain, TI chained across chunks and segment joins.
    Returns its frame count and errors."""
    ten_bit = "10" in pix_fmt
    sub = fr.chroma_subsampling(pix_fmt)
    dims = [(DST_H, DST_W), (DST_H // sub[0], DST_W // sub[1]), (DST_H // sub[0], DST_W // sub[1])]
    side = np.loadtxt(avpvs_path + ".siti.csv", delimiter=",", skiprows=1, ndmin=2)
    plane_err = feat_err = 0.0
    n = 0
    prev = None
    with VideoReader(avpvs_path) as out:
        require((out.width, out.height, out.pix_fmt) == (DST_W, DST_H, pix_fmt),
                f"{avpvs_path}: {out.width}x{out.height} {out.pix_fmt}")
        taker = FrameTaker(out.iter_chunks(avpvs.CHUNK))
        for src in src_chunks:
            plain = [ck.resize_frames_plain(torch.as_tensor(np.ascontiguousarray(p)).to(dev),
                                            h, w, "bicubic") for p, (h, w) in zip(src, dims)]
            t = plain[0].shape[0]
            got = taker.take(t)
            got_dev = [torch.from_numpy(g).to(dev) for g in got]
            plane_err = max(plane_err, *(max_abs(a, b) for a, b in zip(got_dev, plain)))
            si = ck.si_frames_plain(plain[0]).cpu().numpy()
            ti = ck.ti_frames_plain(plain[0], prev).cpu().numpy()
            prev = plain[0][-1]
            feat_err = max(feat_err, float(np.abs(side[n:n + t, 1] - si).max()),
                           float(np.abs(side[n:n + t, 2] - ti).max()))
            n += t
        require(taker.exhausted(), f"{avpvs_path}: frames beyond the source's")
    require(n == frames, f"{avpvs_path}: {n} frames checked, not {frames}")
    require(plane_err <= (1 if ten_bit else 0), f"{avpvs_path}: planes off the plain route by {plane_err}")
    require(len(side) == n and feat_err <= (1e-2 if ten_bit else 1e-3),
            f"{avpvs_path}: {len(side)} sidecar rows for {n} frames, SI/TI off by {feat_err}")
    return {"frames": n, "plane_max_err": plane_err, "siti_max_err": feat_err}


def check_stall(tc, pvs_id: str, spinner: str) -> dict:
    """The stalled or frozen AVPVS: its frame count equal to its plan (a
    freeze's to its wo_buffer render's), the frames at each edge of each
    stall or freeze equal to the compositor's plain torch route on the CPU
    over the plan's gather, its audio the wo_buffer audio with the planned
    silence (a freeze's untouched), and the wo_buffer audio what the
    render carries (`wo_audio`)."""
    pvs = tc.pvses[pvs_id]
    wo, final = pvs.get_avpvs_wo_buffer_file_path(), pvs.get_avpvs_file_path()
    events = pvs.get_buff_events_media_time()
    skipping = pvs.has_framefreeze()
    n_wo = len(medialib.scan_packets(wo, "video")["size"])  # FFV1: a packet a frame
    with VideoReader(wo) as r:
        rate, pix_fmt = r.fps, r.pix_fmt
    plan = ov.plan_stalling(n_wo, rate, events, skipping=skipping, black_frame=True,
                            n_rotations=64)
    n_out = len(medialib.scan_packets(final, "video")["size"])
    require(n_out == plan.n_out and plan.stall_mask.any() and (n_out == n_wo) == skipping,
            f"{final}: {n_out} frames, plan {plan.n_out} with {int(plan.stall_mask.sum())} "
            f"stalled, wo_buffer {n_wo}")
    # the edges: where the mask starts or ends, and each freeze's start
    # (back-to-back freezes join in the mask); 2 frames before each to 5
    # after it, merged
    mask = np.asarray(plan.stall_mask, bool)
    edges = mask_edges(mask)
    if skipping:
        edges |= {int(round(t * rate)) for t, _ in ov.buff_event_pairs(events)}
    windows = edge_windows(edges, n_out)
    # both files decoded once, over the span of the windows
    lo0, hi0 = windows[0][0], windows[-1][1]
    s0, s1 = int(plan.src_idx[lo0:hi0].min()), int(plan.src_idx[lo0:hi0].max()) + 1
    with VideoReader(wo, s0 / rate, (s1 - s0) / rate) as r:
        src, _ = r.read_all()
    with VideoReader(final, lo0 / rate, (hi0 - lo0) / rate) as r:
        out, _ = r.read_all()
    require(src[0].shape[0] == s1 - s0 and out[0].shape[0] == hi0 - lo0,
            f"{final}: frames {lo0}..{hi0 - 1} read {out[0].shape[0]}, wo_buffer frames "
            f"{s0}..{s1 - 1} read {src[0].shape[0]}")
    composite = avpvs.make_stall_compositor(pix_fmt, None if skipping else spinner, skipping,
                                            64, device="cpu")
    for lo, hi in windows:
        idx = plan.src_idx[lo:hi] - s0
        want = composite([torch.from_numpy(p[idx]) for p in src], plan.stall_mask[lo:hi],
                         plan.black_mask[lo:hi], plan.phase[lo:hi])
        require(all(torch.equal(w, torch.from_numpy(o[lo - lo0:hi - lo0]))
                    for w, o in zip(want, out)),
                f"{final}: frames {lo}..{hi - 1} differ from the plain compositor")
    a_wo, srate = medialib.decode_audio_s16(wo, channels=2)
    a_out, _ = medialib.decode_audio_s16(final, channels=2)
    require(np.array_equal(a_wo, wo_audio(pvs)), f"{wo}: audio differs from what it carries")
    a_want = a_wo if skipping else avpvs.insert_stall_silence(a_wo, srate, events)
    require(np.array_equal(a_out, a_want),
            f"{final}: audio {a_out.shape} is not the wo_buffer's "
            f"{'untouched' if skipping else 'with the planned silence'} {a_want.shape}")
    return {"frames": plan.n_out, "stalled": int(mask.sum()),
            "first_stall": int(np.flatnonzero(mask)[0]),
            "checked": [f"{lo}..{hi - 1}" for lo, hi in windows],
            "audio_samples": int(a_out.shape[0])}


def wo_audio(pvs) -> np.ndarray:
    """The stereo audio a wo_buffer AVPVS carries: a short test's first
    segment's, a long test's SRC's over the PVS's total duration."""
    if pvs.test_config.is_short():
        return medialib.decode_audio_s16(pvs.segments[0].file_path, channels=2)[0]
    total = float(sum(s.get_segment_duration() for s in pvs.segments))
    return medialib.decode_audio_s16(pvs.src.file_path, 0.0, total, channels=2)[0]


def run_media(dev, smi: str) -> dict:
    """Phase 18: the media boundary and p03's file-level short path (see
    the module doc)."""
    binding = media_binding()
    with ram_root("phase 18") as root:
        return {"binding": binding, **run_media_db(dev, root, smi)}


def run_media_db(dev, root: str, smi: str) -> dict:
    t0 = time.perf_counter()
    yaml_path = write_database(root, MEDIA_DB, MEDIA_YAML, {})
    src_dir = os.path.dirname(yaml_path) + "/srcVid"
    seg_dir = os.path.dirname(yaml_path) + "/videoSegments"
    os.makedirs(seg_dir, exist_ok=True)
    clip = synthetic_clip(MEDIA_FRAMES, 60, False, SEED + MEDIA_FRAMES)  # 60-frame chunks: 1 s each
    tone = media_tone(MEDIA_FRAMES * MEDIA_SAMPLE_RATE // MEDIA_FPS, SEED)
    write_media(os.path.join(src_dir, "SRC000.avi"), clip, MEDIA_FPS, "yuv420p", tone)
    clip10 = synthetic_clip(MEDIA_FRAMES_10, avpvs.CHUNK, True, SEED + MEDIA_FRAMES_10)
    write_media(os.path.join(src_dir, "SRC001.avi"), clip10, MEDIA_FPS_10, "yuv420p10le", None)
    tc = TestConfig(yaml_path)  # the libav prober: both SRCs are real files now
    half = MEDIA_SAMPLE_RATE
    for seg in tc.segments:
        if seg.src.src_id == "SRC001":
            shutil.copyfile(os.path.join(src_dir, "SRC001.avi"), seg.file_path)
        elif seg.end_time - seg.start_time == 2:
            shutil.copyfile(os.path.join(src_dir, "SRC000.avi"), seg.file_path)
        else:
            k = int(seg.start_time)
            write_media(seg.file_path, [clip[k]], MEDIA_FPS, "yuv420p",
                        tone[k * half:(k + 1) * half])
    write_s = time.perf_counter() - t0
    log(f"media db: {MEDIA_DB} with {len(tc.segments)} FFV1+FLAC segments written in "
        f"{write_s:.2f} s")

    plain8 = [f"{MEDIA_DB}_SRC000_HRC000", f"{MEDIA_DB}_SRC000_HRC001"]
    frozen = f"{MEDIA_DB}_SRC000_HRC002"
    ten = f"{MEDIA_DB}_SRC001_HRC000"
    # (h)'s database, and its p01 in this process beside (b)'s p03 process
    p00_db = p00_database(root, yaml_path, clip)
    b_run = StageProcess("p03", yaml_path, plain8 + [frozen], log_dir=root)
    try:
        t_p01 = time.perf_counter()
        p01 = p01_in_process(dev, p00_db, root, smi)
        log(f"phase 18 (h), p01 in this process beside (b)'s p03 process: "
            f"{time.perf_counter() - t_p01:.1f} s")
        summary, wall = b_run.finish()
    finally:
        b_run.stop()
    log(f"p03 CLI (u8): {json.dumps(summary)}; wall {wall:.2f} s")
    launches = summary["launches"]
    # HRC000's 120 frames; HRC001's and HRC002's first segment, 60 each
    want = chunk_launches(len(stream_chunks([MEDIA_FRAMES, MEDIA_FPS, MEDIA_FPS],
                                            avpvs.chunk_frames(dev))))
    require(launches == want, f"p03 CLI launches {launches} != {want}")
    require(summary["renders"] == 3 and summary["stalls"] == 2,
            f"p03 CLI: {summary['renders']} renders, {summary['stalls']} stalls")
    # one decoder open a rendered segment; a stall pass opens its input
    # twice (its geometry, then its frames)
    require(summary["decoder_opens"] == {"render": 3, "stall": 4},
            f"p03 CLI decoder opens {summary['decoder_opens']}")
    require(summary["bufpool"]["hits"] > 0 and summary["bufpool"]["outstanding"] == 0,
            f"p03 CLI bufpool {summary['bufpool']}")
    # (c) carries the observability flags (one set, one call)
    obs = os.path.join(root, "obs_c")
    status_file = os.path.join(obs, "status.json")
    summary10, wall10 = stage_cli("p03", yaml_path, [ten], "--avpvs-codec", "rawvideo",
                                  "--telemetry", obs, "--profile", obs, "--status-file",
                                  status_file, log_dir=root)
    require(summary10["launches"] == launches_want(resize_frames_fused=3, si_frames_fused=1,
                                                   ti_frames_fused=1)
            and summary10["decoder_opens"] == {"render": 1, "stall": 0},
            f"p03 CLI 10-bit launches {summary10['launches']}, decoder opens "
            f"{summary10['decoder_opens']}")
    # (e)'s p03 process (its own database) and (f)'s p04 process (over
    # (b)'s and (c)'s AVPVS files) run beside the checks of (b)-(d)
    long_run = media_long_start(root, clip, tone)
    p04_run = fused_run = readers = p00_run = p00_ref = None
    try:
        # (c)'s `tools run-report` and `tools chain-profile` processes
        readers = ObsReaders(obs)
        p04_run = P04Run(tc, yaml_path, root)
        pvs = tc.pvses
        t_check = time.perf_counter()
        renders = {
            plain8[0]: check_render(dev, decoded_chunks(pvs[plain8[0]].segments[0].file_path),
                                    pvs[plain8[0]].get_avpvs_file_path(), "yuv420p",
                                    MEDIA_FRAMES),
            plain8[1]: check_render(dev, decoded_chunks(pvs[plain8[1]].segments[0].file_path),
                                    pvs[plain8[1]].get_avpvs_wo_buffer_file_path(), "yuv420p",
                                    MEDIA_FPS),
        }
        stall = check_stall(tc, plain8[1], avpvs.DEFAULT_SPINNER)
        t_freeze = time.perf_counter()
        freeze = check_stall(tc, frozen, avpvs.DEFAULT_SPINNER)
        log(f"phase 18 (d): freeze {frozen}: {freeze['frames']} frames as its wo_buffer render, "
            f"{freeze['stalled']} of them frozen, frames {freeze['checked']} equal to the plain "
            f"compositor on the CPU, audio untouched ({freeze['audio_samples']} samples); check "
            f"{time.perf_counter() - t_freeze:.2f} s ({smi})")
        frames = (sum(r["frames"] for r in renders.values()) + stall["frames"]
                  + 2 * freeze["frames"])
        log(f"p03 file path u8: {frames} AVPVS frames (wo_buffer {renders[plain8[0]]['frames']} "
            f"+ {renders[plain8[1]]['frames']} + {freeze['frames']}, stalled {stall['frames']} "
            f"with {stall['stalled']} stall frames from {stall['first_stall']}, frozen "
            f"{freeze['frames']}) in {summary['seconds']:.3f} s of stage, "
            f"{frames / summary['seconds']:.2f} frames/s (CLI wall {wall:.2f} s with start-up); "
            f"fp_workers {summary['fp_workers']}, threads {summary['threads']}, slices "
            f"{summary['slices']}; checks {time.perf_counter() - t_check:.2f} s ({smi})")
        codec = video_stream(pvs[ten].get_avpvs_file_path())["codec_name"]
        require(codec == "ffv1", f"10-bit rawvideo request wrote {codec}, not the ffv1 fallback")
        render10 = check_render(dev, decoded_chunks(pvs[ten].segments[0].file_path),
                                pvs[ten].get_avpvs_file_path(),
                                "yuv420p10le", MEDIA_FRAMES_10)
        log(f"p03 file path 10-bit: {render10['frames']} frames (rawvideo requested, {codec} "
            f"written), planes within {render10['plane_max_err']} of the plain route, SI/TI "
            f"within {render10['siti_max_err']:.2e}; stage {summary10['seconds']:.3f} s, CLI "
            f"wall {wall10:.2f} s ({smi})")
        flags = check_flags(obs, status_file, summary10, readers, smi)
        t_long = time.perf_counter()
        long_test = media_long(dev, long_run, smi)
        log(f"phase 18 (e), the long test: {time.perf_counter() - t_long:.1f} s after (b)-(d)")
        # (g)'s fused p03 process and (h)'s p00 process run beside (f)'s
        # wait and checks, and the CPU's reference render of (h)'s
        # segments in a thread of this process once its p00 has ended
        fused_run = fused_start(root, yaml_path, plain8[1])
        p00_run = p00_start(root, p00_db)
        p00_ref = P00Reference(p00_db, p00_run, root) if p00_run else None
        t_p04 = time.perf_counter()
        p04 = p04_run.finish(dev, smi)
        log(f"phase 18 (f), p04: {time.perf_counter() - t_p04:.1f} s after (e)")
        t_fused = time.perf_counter()
        fused_p03 = fused_finish(dev, fused_run, tc, summary, p04["summary"], smi)
        log(f"phase 18 (g), fused p03: {time.perf_counter() - t_fused:.1f} s after (f)")
        t_p00 = time.perf_counter()
        p00 = p00_finish(dev, p00_db, p00_run, p00_ref, p01, smi) if p00_run else None
        log(f"phase 18 (h), p00: {time.perf_counter() - t_p00:.1f} s after (g)")
    finally:
        long_run["run"].stop()
        if p00_ref is not None:
            p00_ref.cancelled = True
        if p00_run is not None:
            p00_run["run"].stop()
        if p00_ref is not None:
            p00_ref.thread.join()
        if p04_run is not None:
            p04_run.stop()
        if fused_run is not None:
            fused_run["run"].stop()
            if fused_run.get("p04") is not None:
                fused_run["p04"].stop()
        if readers is not None:
            readers.stop()
    return {"u8": {"summary": summary, "wall_s": wall, "renders": renders, "stall": stall,
                   "freeze": freeze, "frames": frames,
                   "frames_per_s": frames / summary["seconds"]},
            "10bit": {"summary": summary10, "wall_s": wall10, "render": render10},
            "long": long_test, "p04": p04, "flags": flags, "fused": fused_p03,
            "launches": launches, "launches_10bit": summary10["launches"],
            "launches_long": long_test["summary"]["launches"],
            "launches_p04": p04["summary"]["launches"],
            "launches_fused": fused_p03["summary"]["launches"],
            "p01": p01, "p00": p00, "launches_p01": p01["launches"],
            "launches_p00": p00["launches"] if p00 else None,
            "write_s": write_s}


def stream_chunks(frame_counts: list, chunk: int) -> list:
    """The chunk lengths of streams of these frame counts, each cut into
    `chunk`-frame chunks (a long test's segment never shares a chunk)."""
    return [min(chunk, f - k) for f in frame_counts for k in range(0, f, chunk)]


def chunk_launches(n: int) -> dict:
    """The kernel launches of rendering n chunks: 3 resize (Y, U, V), 1 SI
    and 1 TI a chunk."""
    return launches_want(resize_frames_fused=3 * n, si_frames_fused=n, ti_frames_fused=n)


def media_long_start(root: str, clip: list, tone: np.ndarray) -> dict:
    """Phase 18 (e): P2LTR18, the media SRC as a long test, written, and
    its p03 CLI process started (`media_long` waits for it)."""
    t0 = time.perf_counter()
    yaml_path = write_database(root, LONG_DB, LONG_YAML, {})
    write_media(os.path.join(os.path.dirname(yaml_path), "srcVid", "SRC000.avi"), clip,
                MEDIA_FPS, "yuv420p", tone)
    tc = TestConfig(yaml_path)
    half = MEDIA_SAMPLE_RATE
    os.makedirs(os.path.dirname(yaml_path) + "/videoSegments", exist_ok=True)
    for seg in tc.segments:
        k = int(seg.start_time)
        write_media(seg.file_path, [clip[k]], MEDIA_FPS, "yuv420p",
                    tone[k * half:(k + 1) * half])
    pvs_id = f"{LONG_DB}_SRC000_HRC000"
    pvs = tc.pvses[pvs_id]
    rate = avpvs.canvas_fps(pvs)
    per_seg = [int(round(seg.duration * rate)) for seg in pvs.segments]
    return {"tc": tc, "pvs_id": pvs_id, "per_seg": per_seg, "rate": rate,
            "write_s": time.perf_counter() - t0,
            "run": StageProcess("p03", yaml_path, [pvs_id], log_dir=root)}


def media_long(dev, started: dict, smi: str) -> dict:
    """Phase 18 (e): the long test's p03 CLI run waited for: launches from
    its segments' canvas chunks, the stage's decoder opens (one a segment),
    the wo_buffer AVPVS against the plain route over its segments decoded
    in turn, its audio the SRC's, the stalled AVPVS."""
    tc, pvs_id, per_seg, rate = (started[k] for k in ("tc", "pvs_id", "per_seg", "rate"))
    pvs, write_s = tc.pvses[pvs_id], started["write_s"]
    summary, wall = started["run"].finish()
    require(summary["renders"] == 1 and summary["stalls"] == 1,
            f"p03 CLI long: {summary['renders']} renders, {summary['stalls']} stalls")
    want = chunk_launches(len(stream_chunks(per_seg, avpvs.chunk_frames(dev))))
    require(summary["launches"] == want, f"p03 CLI long launches {summary['launches']} != {want}")
    # one decoder open a segment; the stall pass opens its input twice
    opens = summary["decoder_opens"]
    require(opens == {"render": len(pvs.segments), "stall": 2},
            f"p03 CLI long: decoder opens {opens} for {len(pvs.segments)} segments")
    t_check = time.perf_counter()
    # the plain route's input: each segment decoded in turn (the SRC's
    # rate is the canvas's, so the canvas gather keeps every frame)
    require(rate == MEDIA_FPS, f"long: canvas {rate} fps, segments {MEDIA_FPS}")
    src_chunks = itertools.chain.from_iterable(decoded_chunks(seg.file_path)
                                               for seg in pvs.segments)
    render = check_render(dev, src_chunks, pvs.get_avpvs_wo_buffer_file_path(), "yuv420p",
                          sum(per_seg))
    stall = check_stall(tc, pvs_id, avpvs.DEFAULT_SPINNER)
    check_s = time.perf_counter() - t_check
    frames = render["frames"] + stall["frames"]
    log(f"phase 18 (e): long {pvs_id}: {len(pvs.segments)} segments of {per_seg} canvas frames "
        f"(decoder opens {opens}), wo_buffer {render['frames']} frames equal to the plain "
        f"route (planes within {render['plane_max_err']}, SI/TI within "
        f"{render['siti_max_err']:.2e}, TI chained across the join), audio the SRC's over "
        f"{sum(s.get_segment_duration() for s in pvs.segments):.1f} s; stalled "
        f"{stall['frames']} frames with {stall['stalled']} stall frames from "
        f"{stall['first_stall']}; launches {summary['launches']}; {frames} AVPVS frames in "
        f"{summary['seconds']:.3f} s of stage, {frames / summary['seconds']:.2f} frames/s, CLI "
        f"wall {wall:.2f} s; written in {write_s:.2f} s, checks {check_s:.2f} s ({smi})")
    return {"summary": summary, "wall_s": wall, "segments": per_seg, "decoder_opens": opens,
            "render": render, "stall": stall, "frames": frames,
            "frames_per_s": frames / summary["seconds"], "write_s": write_s,
            "check_s": check_s}


def file_state(paths: list) -> dict:
    """(size, mtime_ns) of each path."""
    return {p: (os.stat(p).st_size, os.stat(p).st_mtime_ns) for p in paths}


def video_stream(path: str) -> dict:
    return next(s for s in medialib.probe(path)["streams"] if s["codec_type"] == "video")


def stall_windows(pvs, n_out: int) -> list:
    """Frames 2 before to 5 after each edge of the PVS's stalls (merged),
    and the first frame."""
    wo = pvs.get_avpvs_wo_buffer_file_path()
    if not pvs.has_buffering():
        return [[0, 1]]
    with VideoReader(wo) as r:
        rate = r.fps
    n_wo = len(medialib.scan_packets(wo, "video")["size"])
    plan = ov.plan_stalling(n_wo, rate, pvs.get_buff_events_media_time(),
                            skipping=pvs.has_framefreeze(), black_frame=True, n_rotations=64)
    return edge_windows(mask_edges(plan.stall_mask), n_out, [[0, 1]])


def mask_edges(mask) -> set:
    """The frames where a stall mask starts or ends."""
    mask = np.asarray(mask, bool)
    return set(np.flatnonzero(np.diff(np.r_[False, mask, False].astype(np.int8))).tolist())


def edge_windows(edges, n_out: int, windows: list = None) -> list:
    """[lo, hi) windows from 2 frames before to 5 after each edge, merged,
    appended to `windows` (a fresh list by default)."""
    windows = [] if windows is None else windows
    for e in sorted(edges):
        lo, hi = max(0, e - 2), min(n_out, e + 6)
        if windows and lo <= windows[-1][1]:
            windows[-1][1] = max(windows[-1][1], hi)
        elif lo < hi:
            windows.append([lo, hi])
    return windows


def decoded_avpvs(pvs) -> dict:
    """A PVS's AVPVS decoded once for phase 18 (f)'s checks: its planes,
    rate, pix_fmt and geometry."""
    with VideoReader(pvs.get_avpvs_file_path()) as r:
        planes, _ = r.read_all()
        return {"planes": planes, "fps": r.fps, "pix_fmt": r.pix_fmt,
                "width": r.width, "height": r.height}


def check_cpvs(dev, pvs, pp, cpvs_path: str, av: dict) -> dict:
    """Phase 18 (f)'s checks of one PC CPVS: its frame count against
    cpvs_plan and cpvs_out_rate, its codec, pix_fmt and geometry, its
    decoded planes against the plain route on the card (make_cpvs_transform
    with resize_frames_plain, over the decoded AVPVS `av` resampled with
    the `fps=` index table), bit-exact, and its first frame and the frames
    at the stall's edges against the CPU route."""
    planes, av_fps, pix_fmt = av["planes"], av["fps"], av["pix_fmt"]
    plan = cp.cpvs_plan(pvs, pp, av["height"])
    rate = float(cp.cpvs_out_rate(plan, av_fps))
    n_av = planes[0].shape[0]
    n_want = n_av if rate == av_fps else int(round(n_av / av_fps * rate))
    idx = np.minimum(np.floor(np.arange(n_want) / rate * av_fps + 0.5).astype(np.int64), n_av - 1)
    stream = video_stream(cpvs_path)
    n_got = len(medialib.scan_packets(cpvs_path, "video")["size"])  # a packet a frame
    require(n_got == n_want and stream["codec_name"] == plan["vcodec"]
            and (stream["width"], stream["height"]) == (pp.display_width, pp.display_height),
            f"{cpvs_path}: {n_got} frames ({n_want} planned), {stream['codec_name']} "
            f"{stream['width']}x{stream['height']} (plan {plan['vcodec']})")
    transform = cp.make_cpvs_transform(plan, pp, pix_fmt, False)
    packed = plan["pix_fmt"] == "uyvy422"

    def as_written(planes):
        # the decoder deinterleaves UYVY422 into planes: pack them again
        return [pf.pack_uyvy422(*planes)] if packed else list(planes)

    def as_coded(planes):
        # v210 keeps 10-bit codes in 4..1019 (the encoder clips the two
        # ends, reserved in SDI); UYVY422 stores every code
        return planes if packed else [p.to(torch.int32).clamp(4, 1019).to(p.dtype)
                                      for p in planes]

    def source(lo, hi, device):
        return [torch.from_numpy(np.ascontiguousarray(p[idx[lo:hi]])).to(device)
                for p in planes]

    windows = stall_windows(pvs, n_want)
    err = 0.0
    n = 0
    with VideoReader(cpvs_path) as r:
        for got in r.iter_chunks(avpvs.CHUNK):
            t = got[0].shape[0]
            with plain_resize():
                want = as_coded(transform(source(n, n + t, dev)))
            got_cpu = as_written([torch.from_numpy(np.array(g)) for g in got])
            err = max(err, *(max_abs(a.to(dev), b) for a, b in zip(got_cpu, want)))
            # the CPU route over the windows this chunk holds
            for lo, hi in windows:
                lo_c, hi_c = max(lo, n), min(hi, n + t)
                if lo_c < hi_c:
                    cpu = as_coded(transform(source(lo_c, hi_c, "cpu")))
                    got_w = as_written([torch.from_numpy(np.array(g[lo_c - n:hi_c - n]))
                                        for g in got])
                    require(all(torch.equal(a, b) for a, b in zip(got_w, cpu)),
                            f"{cpvs_path}: frames {lo_c}..{hi_c - 1} differ from the CPU route")
            n += t
    require(n == n_want and err == 0,
            f"{cpvs_path}: {n} frames decoded, planes off the plain route by {err}")
    return {"frames": n_got, "avpvs_frames": n_av, "rate": rate, "codec": stream["codec_name"],
            "pix_fmt": plan["pix_fmt"], "plane_max_err": err,
            "cpu_checked": [f"{lo}..{hi - 1}" for lo, hi in windows],
            "chunks": -(-n_want // avpvs.CHUNK)}


def check_preview(dev, pvs, av) -> dict:
    """Phase 18 (f)'s checks of one preview: codec, geometry, pix_fmt and
    frame count from the prober; given the decoded AVPVS `av`, its encoder
    input (the preview transform on the card, over `av`) against the plain
    route, bit-exact, and the decoded file's luma PSNR against it."""
    path = pvs.get_preview_file_path()
    if av is None:
        src = pvs.get_avpvs_file_path()
        with VideoReader(src) as r:
            w, h = r.width, r.height
        n_av = len(medialib.scan_packets(src, "video")["size"])
    else:
        w, h, n_av = av["width"], av["height"], av["planes"][0].shape[0]
    stream = video_stream(path)
    n_got = len(medialib.scan_packets(path, "video")["size"])
    require((stream["codec_name"], stream["pix_fmt"], stream["width"], stream["height"], n_got)
            == ("prores", "yuv422p10le", w, h, n_av),
            f"{path}: {stream['codec_name']} {stream['pix_fmt']} {stream['width']}x"
            f"{stream['height']}, {n_got} frames ({n_av} in the AVPVS)")
    out = {"frames": n_got, "chunks": -(-n_av // avpvs.CHUNK)}
    if av is None:
        return out
    transform = cp.make_preview_transform(av["pix_fmt"])
    err = 0.0
    sq = count = 0.0
    with VideoReader(path) as r:
        taker = FrameTaker(r.iter_chunks(avpvs.CHUNK))
        for lo in range(0, n_av, avpvs.CHUNK):
            src = [torch.from_numpy(np.ascontiguousarray(p[lo:lo + avpvs.CHUNK])).to(dev)
                   for p in av["planes"]]
            enc = transform(src)  # the kernel's route, as the stage ran it
            with plain_resize():
                plain = transform(src)
            err = max(err, *(max_abs(a, b) for a, b in zip(enc, plain)))
            dec = torch.from_numpy(taker.take(src[0].shape[0])[0].astype(np.float64)).to(dev)
            sq += float(((dec - enc[0].to(torch.float64)) ** 2).sum())
            count += dec.numel()
    psnr = float(10 * np.log10(1023.0 ** 2 / max(sq / count, 1e-12)))
    require(err == 0 and psnr >= PREVIEW_PSNR_DB,
            f"{path}: encoder input off the plain route by {err}, luma PSNR {psnr:.2f} dB "
            f"against it (floor {PREVIEW_PSNR_DB})")
    out.update(encoder_input_max_err=err, luma_psnr_db=psnr)
    return out


#: the ProRes preview's luma PSNR floor (10-bit scale) against its encoder
#: input (tests/test_torch_p04_file.py reads 65-67 dB on its database)
PREVIEW_PSNR_DB = 35.0


class P04Run:
    """Phase 18 (f): `python -m processing_chain_tpu_torch p04 -e` as one
    process on cuda:0 over (b)'s stalled HRC001 (u8: PC rawvideo UYVY422)
    and (c)'s SRC001_HRC000 (10-bit: v210), started once their AVPVS files
    exist; `finish()` waits for it and holds its summary's launches,
    decoder opens and buffer pool, each CPVS and preview (HRC001's in full,
    the 10-bit one probed), and the AVPVS files and sidecars untouched."""

    def __init__(self, tc, yaml_path: str, root: str) -> None:
        encoders = medialib.codecs(P04_ENCODERS, encoder=True)
        missing = [c for c, ok in encoders.items() if not ok]
        require(not missing, f"p04: the bound libav has no {', '.join(missing)} encoder")
        self.tc, self.encoders = tc, encoders
        self.u8, self.ten = f"{MEDIA_DB}_SRC000_HRC001", f"{MEDIA_DB}_SRC001_HRC000"
        pvs = tc.pvses
        self.inputs = [f for pid in (self.u8, self.ten)
                       for f in (pvs[pid].get_avpvs_file_path(),
                                 pvs[pid].get_avpvs_wo_buffer_file_path())
                       for f in (f, avpvs.siti_sidecar_path(f)) if os.path.isfile(f)]
        self.before = file_state(self.inputs)
        self.run = StageProcess("p04", yaml_path, [self.u8, self.ten], "-e", log_dir=root)

    def stop(self) -> None:
        self.run.stop()

    def finish(self, dev, smi: str) -> dict:
        summary, wall = self.run.finish()
        log(f"p04 CLI: {json.dumps(summary)}; wall {wall:.2f} s")
        require(file_state(self.inputs) == self.before, "p04 touched an AVPVS or its sidecar")
        u8, ten, pvs = self.u8, self.ten, self.tc.pvses
        t_check = time.perf_counter()
        pp = self.tc.post_processings[0]
        avs = {pid: decoded_avpvs(pvs[pid]) for pid in (u8, ten)}
        cpvs = {pid: check_cpvs(dev, pvs[pid], pp, pvs[pid].get_cpvs_file_path("pc"), avs[pid])
                for pid in (u8, ten)}
        previews = {u8: check_preview(dev, pvs[u8], avs[u8]),
                    ten: check_preview(dev, pvs[ten], None)}
        del avs
        check_s = time.perf_counter() - t_check
        # two resize launches (U, V: the 420->422 lift) a chunk of each render
        chunks = sum(r["chunks"] for r in [*cpvs.values(), *previews.values()])
        want = launches_want(resize_frames_fused=2 * chunks)
        require(summary["launches"] == want, f"p04 CLI launches {summary['launches']} != {want}")
        require(summary["renders"] == 4 and summary["decoder_opens"] == 4,
                f"p04 CLI: {summary['renders']} renders, {summary['decoder_opens']} decoder opens")
        require(summary["bufpool"]["hits"] > 0 and summary["bufpool"]["outstanding"] == 0,
                f"p04 CLI bufpool {summary['bufpool']}")
        frames = summary["frames"]
        log(f"phase 18 (f): p04 {u8} PC {cpvs[u8]['codec']} {cpvs[u8]['pix_fmt']} "
            f"{cpvs[u8]['frames']} frames at {cpvs[u8]['rate']} fps, {ten} PC "
            f"{cpvs[ten]['codec']} {cpvs[ten]['frames']} frames ({cpvs[ten]['avpvs_frames']} "
            f"AVPVS frames at {cpvs[ten]['rate']} fps), both equal to the plain route on the card "
            f"and frames {cpvs[u8]['cpu_checked']} / {cpvs[ten]['cpu_checked']} to the CPU "
            f"route; previews {previews[u8]['frames']} / {previews[ten]['frames']} frames, "
            f"encoder input equal to the plain route, decoded at "
            f"{previews[u8]['luma_psnr_db']:.2f} dB; launches {summary['launches']}, decoder "
            f"opens {summary['decoder_opens']}, bufpool {summary['bufpool']}; {frames} frames in "
            f"{summary['seconds']:.3f} s of stage, {frames / summary['seconds']:.2f} frames/s "
            f"(decode {summary['decode_s']:.3f} s, device {summary['device_s']:.3f} s, "
            f"writeback {summary['writeback_s']:.3f} s), CLI wall {wall:.2f} s with start-up, "
            f"beside (e)'s process and the checks of (b)-(d); checks {check_s:.2f} s ({smi})")
        return {"summary": summary, "wall_s": wall, "cpvs": cpvs, "previews": previews,
                "frames_per_s": frames / summary["seconds"], "check_s": check_s,
                "encoders": self.encoders}


class ObsReaders:
    """Phase 18 (c): `tools run-report DIR` and `tools chain-profile DIR`
    over the flagged call's directory, as two processes started together;
    `finish()` waits for both and checks their exit codes."""

    TOOLS = ("run-report", "chain-profile")

    def __init__(self, obs: str) -> None:
        self.procs = {}
        for tool in self.TOOLS:
            # chainlint: disable=subprocess-hygiene (a reader tool as a process; finish() waits with a timeout and checks its exit code, stop() kills it)
            self.procs[tool] = subprocess.Popen(
                [sys.executable, "-m", "processing_chain_tpu_torch", "tools", tool, obs],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(self) -> dict:
        out = {}
        for tool, proc in self.procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            require(proc.returncode == 0 and stdout.strip(),
                    f"tools {tool}: exit {proc.returncode}: {stderr[-2000:]}")
            out[tool] = stdout
        return out

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


def check_flags(obs: str, status_file: str, summary: dict, readers: ObsReaders,
                smi: str) -> dict:
    """Phase 18 (c)'s observability flags (`--telemetry DIR --profile DIR
    --status-file F` on one call): the artifact set under one stamp, the
    device trace's kernel events per family equal to the call's summary
    launches, the event stream's run records, the status file's final
    snapshot, and the two reader tools' exit codes."""
    names = set(os.listdir(obs))
    (metrics,) = [n for n in names if n.startswith("metrics_") and n.endswith(".json")]
    stamp = metrics[len("metrics_"):-len(".json")]
    want = {f"metrics_{stamp}.json", f"metrics_{stamp}.prom", f"events_{stamp}.jsonl",
            f"trace_{stamp}.json", f"profile_{stamp}.trace.json", f"resources_{stamp}.json",
            f"device_{stamp}", os.path.basename(status_file)}
    require(want <= names, f"flags: artifacts {sorted(names)}, missing {sorted(want - names)}")
    trace = profiling.load_device_trace(os.path.join(obs, f"device_{stamp}"))
    counts, symbols = trace_launches(trace)
    launches = summary["launches"]
    families = {}
    for fam in {ck.launch_names(sym) for sym in symbols} | {
            ("resize_frames_fused",), ("si_frames_fused",), ("ti_frames_fused",)}:
        n = sum(launches[k] for k in fam)
        families["+".join(fam)] = {"trace": counts.get(fam, 0), "launches": n}
        require(counts.get(fam, 0) == n and (n > 0 or len(fam) > 1),
                f"flags: {'+'.join(fam)}: {counts.get(fam, 0)} kernel events in the device "
                f"trace, {n} launches in the summary")
    with open(os.path.join(obs, f"events_{stamp}.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    kinds = [e["event"] for e in events]
    ends = [e for e in events if e["event"] == "run_end"]
    require(kinds[0] == "log_meta" and "run_start" in kinds and "stage_start" in kinds
            and len(ends) == 1 and ends[0]["status"] == "ok",
            f"flags: event log {sorted(set(kinds))}, run_end {ends}")
    with open(status_file) as f:
        status = json.load(f)
    require(status["run"]["name"] == "p03" and status["tasks"] == [],
            f"flags: final status snapshot {status.get('run')}, tasks {status.get('tasks')}")
    reports = readers.finish()
    log(f"phase 18 (c) flags: --telemetry/--profile/--status-file wrote {sorted(want)}; device "
        f"trace kernels by family {families}; {len(events)} events; final status "
        f"{status['run']['name']} with no task in flight; run-report "
        f"{len(reports['run-report'].splitlines())} lines, chain-profile "
        f"{len(reports['chain-profile'].splitlines())} lines, both exit 0 ({smi})")
    return {"stamp": stamp, "families": families, "events": len(events),
            "report_lines": {k: len(v.splitlines()) for k, v in reports.items()}}


def fused_start(root: str, yaml_path: str, pvs_id: str) -> dict:
    """Phase 18 (g): a copy of P2STR18 (its YAML, SRCs and segments, no
    render) in its own directory, and `PC_FUSE_P04=1 python -m
    processing_chain_tpu_torch p03` over the stall PVS as a process."""
    src = os.path.dirname(yaml_path)
    dst = os.path.join(root, "fused", MEDIA_DB)
    skip = ("avpvs", "cpvs", "logs")
    shutil.copytree(src, dst, ignore=lambda d, names: [n for n in names if d == src
                                                       and n in skip])
    for sub in ("avpvs", "cpvs"):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
    copy = os.path.join(dst, os.path.basename(yaml_path))
    return {"yaml": copy, "pvs_id": pvs_id,
            "run": StageProcess("p03", copy, [pvs_id], log_dir=root, env={"PC_FUSE_P04": "1"})}


def same_media(a: str, b: str, tol: int = 0) -> str:
    """"bytes" when the two files are byte-identical, "decoded" when their
    decoded planes and audio are, "within <tol>" when the planes are
    within `tol` code values (and the audio equal), else the run fails."""
    if filecmp.cmp(a, b, shallow=False):
        return "bytes"
    n = len(medialib.scan_packets(a, "video")["size"])  # a packet a frame
    require(len(medialib.scan_packets(b, "video")["size"]) == n, f"{b}: not {n} frames as {a}")
    with VideoReader(a) as ra, VideoReader(b) as rb:
        ta, tb = FrameTaker(ra.iter_chunks(avpvs.CHUNK)), FrameTaker(rb.iter_chunks(avpvs.CHUNK))
        for lo in range(0, n, avpvs.CHUNK):
            t = min(avpvs.CHUNK, n - lo)
            pairs = list(zip(ta.take(t), tb.take(t)))
            err = 0 if all(np.array_equal(p, q) for p, q in pairs) else max(
                int(np.abs(p.astype(np.int32) - q.astype(np.int32)).max()) for p, q in pairs)
            require(err <= tol, f"{b}: frames {lo}..{lo + t - 1} differ from {a} by {err}")
    try:
        aa = medialib.decode_audio_s16(a)
    except medialib.MediaError:
        aa = None
    try:
        ab = medialib.decode_audio_s16(b)
    except medialib.MediaError:
        ab = None
    require((aa is None) == (ab is None) and (aa is None or (
        aa[1] == ab[1] and np.array_equal(aa[0], ab[0]))), f"{b}: audio differs from {a}")
    return "decoded" if tol == 0 else f"within {tol}"


def fused_finish(dev, started: dict, tc, staged_p03: dict, staged_p04: dict, smi: str) -> dict:
    """Phase 18 (g): the fused p03 process waited for: one decoder open
    (the segment) and none for a stall pass, the launches of its canvas
    chunks plus the PC context's 420->422 lift (2 a composited chunk), both
    members committed; its wo_buffer AVPVS and .siti.csv, its stalled AVPVS
    and its PC UYVY CPVS equal to (b)'s and (f)'s staged files; then a p04
    process over the copy plans no job."""
    summary, wall = started["run"].finish()
    pvs_id, copy = started["pvs_id"], started["yaml"]
    log(f"p03 CLI (fused): {json.dumps(summary)}; wall {wall:.2f} s")
    # p04 after the fused p03, beside the file checks
    started["p04"] = StageProcess("p04", copy, [pvs_id],
                                  log_dir=os.path.dirname(os.path.dirname(copy)))
    staged, fused_pvs = tc.pvses[pvs_id], TestConfig(copy).pvses[pvs_id]
    require(summary["renders"] == 1 and summary["stalls"] == 0
            and summary["decoder_opens"] == {"render": 1, "stall": 0}
            and summary["fused"] == {"fanouts": 1, "members": 2, "degraded": 0},
            f"p03 CLI fused: renders {summary['renders']}, stalls {summary['stalls']}, decoder "
            f"opens {summary['decoder_opens']}, fan-out {summary['fused']}")
    chunk = avpvs.chunk_frames(dev)
    n_stalled = len(medialib.scan_packets(staged.get_avpvs_file_path(), "video")["size"])
    pp = tc.post_processings[0]
    plan = cp.cpvs_plan(staged, pp, avpvs.avpvs_dimensions(staged)[1])
    rate = float(cp.cpvs_out_rate(plan, MEDIA_FPS))
    # the PC pipeline takes each composited chunk as it comes, or, where it
    # resamples, chunks of its own output frames
    pc_chunks = (len(stream_chunks([n_stalled], chunk)) if rate == MEDIA_FPS
                 else -(-int(round(n_stalled / MEDIA_FPS * rate)) // chunk))
    canvas = len(stream_chunks([MEDIA_FPS], chunk))  # HRC001 renders its first 1 s segment
    want = launches_want(resize_frames_fused=3 * canvas + 2 * pc_chunks,
                         si_frames_fused=canvas, ti_frames_fused=canvas)
    require(summary["launches"] == want,
            f"p03 CLI fused launches {summary['launches']} != {want} ({canvas} canvas chunks, "
            f"{pc_chunks} PC chunks)")
    t_check = time.perf_counter()
    pairs = {
        "wo_buffer": (staged.get_avpvs_wo_buffer_file_path(),
                      fused_pvs.get_avpvs_wo_buffer_file_path()),
        "stalled": (staged.get_avpvs_file_path(), fused_pvs.get_avpvs_file_path()),
        "pc_cpvs": (staged.get_cpvs_file_path("pc"), fused_pvs.get_cpvs_file_path("pc")),
    }
    equal = {k: same_media(a, b) for k, (a, b) in pairs.items()}
    side = [avpvs.siti_sidecar_path(p) for p in pairs["wo_buffer"]]
    with open(side[0], "rb") as fa, open(side[1], "rb") as fb:
        require(fa.read() == fb.read(), f"{side[1]} differs from the staged {side[0]}")
    check_s = time.perf_counter() - t_check
    p04, p04_wall = started["p04"].finish()
    require(p04["renders"] == 0 and p04["decoder_opens"] == 0,
            f"p04 after the fused p03 ran {p04['renders']} jobs, {p04['decoder_opens']} decoder "
            "opens")
    n_cpvs = len(medialib.scan_packets(pairs["pc_cpvs"][1], "video")["size"])
    frames = MEDIA_FPS + n_stalled + n_cpvs
    secs = summary["seconds"]
    log(f"phase 18 (g): fused {pvs_id}: wo_buffer, stalled ({n_stalled} frames) and PC UYVY "
        f"CPVS ({n_cpvs} frames) equal to (b)'s and (f)'s staged files ({equal}), .siti.csv "
        f"byte-equal; decoder opens {summary['decoder_opens']}; launches {summary['launches']} "
        f"({canvas} canvas + {pc_chunks} PC chunks); {frames} output frames in {secs:.3f} s of "
        f"stage, {frames / secs:.2f} frames/s (decode {summary['decode_s']:.3f} s, device "
        f"{summary['device_s']:.3f} s, writeback {summary['writeback_s']:.3f} s), CLI wall "
        f"{wall:.2f} s; staged (b) p03 {staged_p03['seconds']:.3f} s (decode "
        f"{staged_p03['decode_s']:.3f}, device {staged_p03['device_s']:.3f}, writeback "
        f"{staged_p03['writeback_s']:.3f}; {staged_p03['frames']} frames, 3 PVSes), (f) p04 "
        f"{staged_p04['seconds']:.3f} s (decode {staged_p04['decode_s']:.3f}, device "
        f"{staged_p04['device_s']:.3f}, writeback {staged_p04['writeback_s']:.3f}; "
        f"{staged_p04['frames']} frames, 4 renders); p04 after it planned 0 jobs (wall "
        f"{p04_wall:.2f} s); checks {check_s:.2f} s ({smi})")
    return {"summary": summary, "wall_s": wall, "equal": equal, "frames": frames,
            "frames_per_s": frames / secs, "pc_chunks": pc_chunks, "canvas_chunks": canvas,
            "p04_after": p04, "check_s": check_s}


# phase 18 (h): p01 and p00 from a source video

P00_DB = "P2STR180"  # the database id syntax takes digits only (P2STR18E does not parse)
#: each of p01's encoders: its video codec and the coding fields that keep
#: the 720p encode short (the database's libvpx speed goes up to 4)
P01_CODINGS = {"libvpx-vp9": ("vp9", "speed: 4"), "libx265": ("h265", "preset: ultrafast"),
               "libaom-av1": ("av1", "cpuUsed: 8"), "libx264": ("h264", "preset: ultrafast")}
# a short test over phase 18's SRCs: the 640x360 rung at 30 fps (a drop
# from 60), the 1280x720 rung at the SRC's rate, a 0.5 s stall between
# HRC000's two 1 s segments, the 10-bit SRC at 720p; the pc context at
# 1920x1080 (the P.NATS HD context)
P00_YAML = """\
databaseId: {db_id}
syntaxVersion: 6
type: short
qualityLevelList:
  Q0: {{index: 0, videoCodec: {codec}, videoBitrate: 1000, width: 640, height: 360, fps: 30}}
  Q1: {{index: 1, videoCodec: {codec}, videoBitrate: 3000, width: 1280, height: 720, fps: original}}
codingList:
  VC01: {{type: video, encoder: {encoder}, passes: {passes}, iFrameInterval: 1, {extra}}}
srcList:
  SRC000: SRC000.avi
  SRC001: SRC001.avi
hrcList:
  HRC000: {{videoCodingId: VC01, eventList: [[Q0, 1], [stall, 0.5], [Q1, 1]]}}
  HRC001: {{videoCodingId: VC01, eventList: [[Q1, 1]]}}
pvsList:
  - {db_id}_SRC000_HRC000
  - {db_id}_SRC001_HRC001
postProcessingList:
  - {{type: pc, displayWidth: 1920, displayHeight: 1080, codingWidth: 1920, codingHeight: 1080}}
"""


class RecordingWriter:
    """Stands in for models.segments' VideoWriter in (h)'s in-process p01
    runs: `record` maps each output path to the sha1 of each plane of each
    frame it is handed, the chunks it took and, for planes deeper than 8
    bits, the planes themselves; an empty file stands at the path (the
    encode removes its pass-1 temporary)."""

    record: dict = {}

    def __init__(self, path: str, codec: str, width: int, height: int,
                 pix_fmt: str = "yuv420p", **_kw) -> None:
        self.path = path
        self.rows = self.record.setdefault(path, {"frames": [], "chunks": 0, "planes": [],
                                                  "geometry": [width, height, pix_fmt]})
        fsio.atomic_write_text(path, "")

    def write_batch(self, *planes) -> None:
        arrs = [np.ascontiguousarray(p) for p in planes]
        self.rows["chunks"] += 1
        if arrs[0].dtype != np.uint8:
            self.rows["planes"].append([a.copy() for a in arrs])
        for i in range(arrs[0].shape[0]):
            self.rows["frames"].append(tuple(hashlib.sha1(a[i].tobytes()).hexdigest()
                                             for a in arrs))

    def write_audio(self, samples) -> None:
        pass

    def close(self) -> None:
        pass


def link_tree(src: str, dst: str, subs=("srcVid",)) -> str:
    """A copy of a database folder's YAML and `subs` under `dst`, its
    files hard-linked (one tmpfs); returns the copy's YAML path."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        path = os.path.join(src, name)
        if os.path.isfile(path):
            shutil.copyfile(path, os.path.join(dst, name))
    for sub in subs:
        shutil.copytree(os.path.join(src, sub), os.path.join(dst, sub), copy_function=os.link)
    return os.path.join(dst, os.path.basename(src) + ".yaml")


def p01_inputs(yaml_path: str, device) -> dict:
    """The port's p01 stage in this process on `device` over the database,
    models.segments' writer replaced by RecordingWriter: {"inputs": {path
    relative to the database: record}, "launches", "seconds"}."""
    from processing_chain_tpu_torch import cli as stage_cli_mod

    RecordingWriter.record = {}
    saved = segments.VideoWriter
    segments.VideoWriter = RecordingWriter
    ck.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = stage_cli_mod.main(["p01", "-c", yaml_path, "-p", "3", "--skip-requirements"],
                                device=device)
    finally:
        segments.VideoWriter = saved
    launches, secs = dict(ck.LAUNCHES), time.perf_counter() - t0
    require(rc == 0, f"p01 in-process on {device}: exit {rc}")
    root = os.path.dirname(yaml_path)
    return {"inputs": {os.path.relpath(p, root): r for p, r in RecordingWriter.record.items()},
            "launches": launches, "seconds": secs}


def p00_database(root: str, media_yaml: str, clip: list) -> dict:
    """(h)'s database: the first of P01_ENCODERS the bound libav has that
    opens both yuv420p and yuv420p10le (else the first that opens
    yuv420p, its 10-bit PVS then left out of the process), two passes where
    the encoder keeps its own statistics (x264, x265) or its round trip at
    load passed; SRC000 and SRC001 are phase 18's files, SRC000 without
    its audio where the bound libav has no aac encoder (the segment
    container's). None when no encoder of the four is bound."""
    have = medialib.codecs(P01_ENCODERS + ("aac",), encoder=True)
    opens = {}
    for enc in P01_ENCODERS:
        if not have[enc]:
            continue
        for pix in ("yuv420p", "yuv420p10le"):
            probe = os.path.join(root, f"open_{enc}_{pix}.mkv")
            try:
                VideoWriter(probe, enc, 64, 64, pix, (30, 1), threads=1,
                            opts="x265-params=log-level=error" if enc == "libx265" else "").close()
                opens[(enc, pix)] = True
            except medialib.MediaError:
                opens[(enc, pix)] = False
            if os.path.exists(probe):
                os.unlink(probe)
    both = [e for e in P01_ENCODERS if opens.get((e, "yuv420p")) and opens.get((e, "yuv420p10le"))]
    eight = [e for e in P01_ENCODERS if opens.get((e, "yuv420p"))]
    encoder = (both or eight or [None])[0]
    twopass = medialib.twopass()
    # an encoder that is bound but not in `eight` failed to open; the
    # in-process check runs anyway, with the first listed
    chosen = encoder or next((e for e in P01_ENCODERS if have[e]), P01_ENCODERS[-1])
    passes = 2 if chosen in ("libx264", "libx265") or twopass.get(chosen) == "ok" else 1
    codec, extra = P01_CODINGS[chosen]
    folder = os.path.join(root, "p00", "base", P00_DB)
    src_dir = os.path.join(folder, "srcVid")
    os.makedirs(src_dir, exist_ok=True)
    fsio.atomic_write_text(os.path.join(folder, P00_DB + ".yaml"), P00_YAML.format(
        db_id=P00_DB, codec=codec, encoder=chosen, passes=passes, extra=extra))
    media_src = os.path.join(os.path.dirname(media_yaml), "srcVid")
    os.link(os.path.join(media_src, "SRC001.avi"), os.path.join(src_dir, "SRC001.avi"))
    if have["aac"]:
        os.link(os.path.join(media_src, "SRC000.avi"), os.path.join(src_dir, "SRC000.avi"))
    else:
        write_media(os.path.join(src_dir, "SRC000.avi"), clip, MEDIA_FPS, "yuv420p", None)
    pvses = [f"{P00_DB}_SRC000_HRC000", f"{P00_DB}_SRC001_HRC001"]
    return {"yaml": os.path.join(folder, P00_DB + ".yaml"), "encoder": encoder,
            "chosen": chosen, "passes": passes, "audio": bool(have["aac"]),
            "opens": {f"{e} {p}": ok for (e, p), ok in opens.items()},
            "pvses": pvses if encoder in both else pvses[:1]}


def p00_start(root: str, db: dict):
    """(h)'s p00 process over a copy of the database (SRCs only), or None
    where no encoder of the four opens."""
    if db["encoder"] is None:
        log(f"phase 18 (h): none of {list(P01_ENCODERS)} opens on the bound libav "
            f"({json.dumps(db['opens'])}): no p00 process is started")
        return None
    yaml_path = link_tree(os.path.dirname(db["yaml"]), os.path.join(root, "p00", "proc", P00_DB))
    return {"yaml": yaml_path,
            "run": StageProcess("p00", yaml_path, db["pvses"], log_dir=root)}


def p01_in_process(dev, db: dict, root: str, smi: str) -> dict:
    """(h) in this process: the port's p01 over the database on cuda:0 and
    on the CPU, each with the recording writer: every u8 encoder-input
    plane's sha1 equal between the two (u16 planes, which take the resize
    kernel's f32 route rather than the golden integer path, within one
    code value, the JAX package's stated tolerance for it), every
    segment's frame count equal and the plan's (its duration at its output
    rate), and 3 resize launches a chunk on the card."""
    base = os.path.dirname(db["yaml"])
    runs = {}
    for tag, device in (("card", dev), ("cpu", "cpu")):
        yaml_path = link_tree(base, os.path.join(root, "p00", tag, P00_DB))
        runs[tag] = p01_inputs(yaml_path, device)
    card, cpu = runs["card"], runs["cpu"]
    require(sorted(card["inputs"]) == sorted(cpu["inputs"]),
            f"p01: the card wrote {sorted(card['inputs'])}, the CPU {sorted(cpu['inputs'])}")
    tc = TestConfig(db["yaml"])
    frames = {}
    u16_err = 0
    for seg in tc.segments:
        rel = os.path.relpath(seg.file_path, os.path.dirname(db["yaml"]))
        paths = [p for p in card["inputs"] if p.startswith(rel)]
        require(len(paths) == db["passes"], f"p01: {rel}: {len(paths)} writers, "
                f"{db['passes']} passes")
        _, _, _, out_fps = segments.plan_segment_frames(seg)
        want = int(round(seg.duration * out_fps))
        for p in paths:
            a, b = card["inputs"][p], cpu["inputs"][p]
            require(len(a["frames"]) == len(b["frames"]) == want and
                    a["geometry"] == b["geometry"],
                    f"p01: {p}: {len(a['frames'])} frames on the card, {len(b['frames'])} on "
                    f"the CPU, the plan {want} ({seg.duration} s at {out_fps} fps)")
            if not a["planes"]:
                require(a["frames"] == b["frames"],
                        f"p01: {p}: the card's encoder input differs from the CPU's")
                continue
            ga = [np.concatenate([c[k] for c in a["planes"]]) for k in range(3)]
            gb = [np.concatenate([c[k] for c in b["planes"]]) for k in range(3)]
            diff = max(int(np.abs(x.astype(np.int32) - y.astype(np.int32)).max())
                       for x, y in zip(ga, gb))
            u16_err = max(u16_err, diff)
            require(diff <= 1, f"p01: {p}: u16 planes {diff} code values off the CPU's")
        frames[seg.filename] = want
    chunks = sum(r["chunks"] for r in card["inputs"].values())
    want_l = launches_want(resize_frames_fused=3 * chunks)
    require(card["launches"] == want_l, f"p01 on the card: launches {card['launches']} != {want_l}")
    require(not any(cpu["launches"].values()), f"p01 on the CPU launched {cpu['launches']}")
    n = sum(len(r["frames"]) for r in card["inputs"].values())
    log(f"phase 18 (h): p01 in-process over {P00_DB} ({db['chosen']}, {db['passes']} "
        f"pass(es)): {len(frames)} segments {json.dumps(frames)}, {n} encoder-input frames "
        f"(every pass) with every u8 plane's sha1 equal on cuda:0 and the CPU, u16 planes "
        f"within {u16_err}; launches "
        f"{card['launches']['resize_frames_fused']} ({chunks} chunks); card {card['seconds']:.2f} "
        f"s ({n / card['seconds']:.2f} frames/s), CPU {cpu['seconds']:.2f} s ({smi})")
    return {"launches": card["launches"], "frames": frames, "chunks": chunks,
            "encoder_input_frames": n, "u16_max_err": u16_err, "card_s": card["seconds"],
            "cpu_s": cpu["seconds"]}


class P00Reference:
    """(h)'s reference: once its p00 process has ended (exit 0), the port's
    render of the same segment files on the CPU, in a thread of this
    process, into a copy of the database: create_avpvs_wo_buffer,
    apply_stalling (the stage's spinner) and create_cpvs of each PVS.
    Only the CPU runs here, so the card's launch counts and the kernel
    wrappers the main thread swaps are never touched."""

    def __init__(self, db: dict, started: dict, root: str) -> None:
        self.db, self.started, self.root = db, started, root
        self.cancelled = False
        self.error = None
        self.yaml = self.seconds = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        try:
            if self.started["run"].proc.wait() != 0 or self.cancelled:
                return
            t0 = time.perf_counter()
            folder = os.path.dirname(self.started["yaml"])
            ref_yaml = link_tree(folder, os.path.join(self.root, "p00", "ref", P00_DB),
                                 subs=("srcVid", "videoSegments"))
            for sub in ("avpvs", "cpvs"):
                os.makedirs(os.path.join(os.path.dirname(ref_yaml), sub), exist_ok=True)
            ref = TestConfig(ref_yaml)
            for pid in self.db["pvses"]:
                pvs = ref.pvses[pid]
                avpvs.create_avpvs_wo_buffer(pvs, device="cpu").run()
                if pvs.has_buffering():
                    avpvs.apply_stalling(pvs, spinner_path=avpvs.DEFAULT_SPINNER,
                                         device="cpu").run()
                for pp in ref.post_processings:
                    cp.create_cpvs(pvs, pp, device="cpu").run()
            self.yaml, self.seconds = ref_yaml, time.perf_counter() - t0
        except BaseException as exc:  # noqa: BLE001 - re-raised by result() on the main thread
            self.error = exc

    def result(self) -> tuple:
        self.thread.join()
        if self.error is not None:
            raise self.error
        require(self.yaml is not None, "p00: the CPU's reference render did not run")
        return self.yaml, self.seconds


def p00_finish(dev, db: dict, started: dict, reference: P00Reference, p01: dict,
               smi: str) -> dict:
    """(h)'s p00 process waited for: every segment probes at its planned
    geometry, pixel format, rate and frame count; .qchanges, .vfi, .afi
    and (HRC000) .buff exist, the .vfi rows equal the segments' frames and
    the .buff events the HRC's; each AVPVS (wo_buffer and stalled) and PC
    CPVS equal to `reference`, the port's render of the same segment files
    on the CPU in this process (a 10-bit PVS within a code value: its u16
    resize is f32 arithmetic); the launches of its stages; then a p00 in
    this process over the same database plans no job."""
    from processing_chain_tpu_torch import cli as stage_cli_mod

    summaries, wall = started["run"].finish_stages(["p01", "p03", "p04"])
    t_check = time.perf_counter()
    yaml_path = started["yaml"]
    folder = os.path.dirname(yaml_path)
    tc = TestConfig(yaml_path)
    wanted = set(db["pvses"])
    used = {s.filename for p in wanted for s in tc.pvses[p].segments}
    for seg in tc.segments:
        if seg.filename not in used:
            continue
        th, tw, _, out_fps = segments.plan_segment_frames(seg)
        [st] = [x for x in medialib.probe(seg.file_path)["streams"] if x["codec_type"] == "video"]
        from fractions import Fraction
        n = len(medialib.scan_packets(seg.file_path, "video")["size"])
        got = (st["width"], st["height"], st["pix_fmt"], Fraction(st["r_frame_rate"]), n)
        want = (tw, th, seg.target_pix_fmt, Fraction(out_fps).limit_denominator(1001),
                p01["frames"][seg.filename])
        require(got == want, f"p00: {seg.filename} probes {got}, planned {want}")
    families = {"qchanges": tc.get_quality_change_event_files_path(),
                "vfi": tc.get_video_frame_information_path(),
                "afi": tc.get_audio_frame_information_path(),
                "buff": tc.get_buff_event_files_path()}
    for pid in wanted:
        pvs = tc.pvses[pid]
        for fam, path in families.items():
            f = os.path.join(path, f"{pid}.{fam}")
            require(os.path.isfile(f) == (fam != "buff" or pvs.has_buffering()),
                    f"p00: {f} exists: {os.path.isfile(f)}")
        with open(os.path.join(families["vfi"], f"{pid}.vfi")) as fv:
            rows = len(fv.read().splitlines()) - 1
        want_rows = sum(p01["frames"][s.filename] for s in pvs.segments)
        require(rows == want_rows, f"p00: {pid}.vfi has {rows} rows, its segments {want_rows} "
                "frames")
        if pvs.has_buffering():
            with open(os.path.join(families["buff"], f"{pid}.buff")) as fb:
                text = fb.read()
            want_text = "\n".join(str(e) for e in pvs.get_buff_events_media_time()) + "\n"
            require(text == want_text, f"p00: {pid}.buff {text!r} != the HRC's {want_text!r}")
    # the CPU's render of the same segment files, in this process
    ref_yaml, ref_s = reference.result()
    saved = {k: os.environ.get(k) for k in ("PC_FFV1_WORKERS", "PC_FFV1_THREADS")}
    try:
        ref = TestConfig(ref_yaml)
        equal = {}
        for pid in wanted:
            pvs, rpvs = tc.pvses[pid], ref.pvses[pid]
            pairs = {"avpvs": (rpvs.get_avpvs_file_path(), pvs.get_avpvs_file_path()),
                     "pc": (rpvs.get_cpvs_file_path("pc"), pvs.get_cpvs_file_path("pc"))}
            if pvs.has_buffering():
                pairs["wo_buffer"] = (rpvs.get_avpvs_wo_buffer_file_path(),
                                      pvs.get_avpvs_wo_buffer_file_path())
            # u16 renders take the resize kernel's f32 route on the card
            tol = 1 if pvs.segments[0].uses_10_bit() else 0
            equal[pid] = {k: same_media(a, b, tol) for k, (a, b) in pairs.items()}
        # a warm p00 over the same database, in this process: no job planned
        planned = {r: 0.0 for r in ("p01", "p02", "p03", "p03-stall", "p04")}
        was = serve_tm.enabled()
        serve_tm.enable()
        try:
            before = {r: _metric_sum("chain_jobs_planned_total", {"runner": r}) for r in planned}
            require(stage_cli_mod.main(["p00", "-c", yaml_path, "-p", "1", "--skip-requirements",
                                        "--filter-pvs", "|".join(db["pvses"])], device=dev) == 0,
                    "p00: the warm re-run failed")
            planned = {r: _metric_sum("chain_jobs_planned_total", {"runner": r}) - before[r]
                       for r in planned}
        finally:
            if not was:
                serve_tm.disable()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(not any(planned.values()), f"p00: the warm re-run planned {planned}")
    # launches: p01's as in this process on the card; p03's 3 + 1 + 1 a
    # canvas chunk; p04's 2 (the 420->422 lift) a chunk of each CPVS
    s01, s03, s04 = (summaries[k] for k in ("p01", "p03", "p04"))

    def frames_of(path: str) -> int:
        return len(medialib.scan_packets(path, "video")["size"])  # a packet a frame

    canvas = [frames_of(tc.pvses[p].get_avpvs_wo_buffer_file_path() if tc.pvses[p].has_buffering()
                        else tc.pvses[p].get_avpvs_file_path()) for p in db["pvses"]]
    cpvs_frames = [frames_of(tc.pvses[p].get_cpvs_file_path("pc")) for p in db["pvses"]]
    chunk = avpvs.chunk_frames(dev)
    want = {"p01": p01["launches"],
            "p03": chunk_launches(len(stream_chunks(canvas, chunk))),
            "p04": launches_want(resize_frames_fused=2 * len(stream_chunks(cpvs_frames, chunk)))}
    for k, sm in (("p01", s01), ("p03", s03), ("p04", s04)):
        require(sm["launches"] == want[k], f"p00's {k}: launches {sm['launches']} != {want[k]}")
    launches = {k: sum(sm["launches"][k] for sm in (s01, s03, s04)) for k in ck.LAUNCHES}
    check_s = time.perf_counter() - t_check
    log(f"phase 18 (h): p00 process over {db['pvses']} ({db['encoder']}, {db['passes']} "
        f"pass(es), SRC000 audio {db['audio']}): {s01['encodes']} encodes in "
        f"{s01['seconds']:.3f} s, p03 {s03['renders']} renders + {s03['stalls']} stalls in "
        f"{s03['seconds']:.3f} s, p04 {s04['renders']} renders in {s04['seconds']:.3f} s, wall "
        f"{wall:.2f} s; segments at their planned geometry, rate and frames; metadata frame "
        f"counts and .buff as planned; AVPVS ({canvas} canvas frames) and PC CPVS "
        f"({cpvs_frames} frames) equal to the CPU's render ({json.dumps(equal)}, rendered in "
        f"{ref_s:.2f} s in a thread beside (f) and (g)); launches {launches}; the "
        f"warm re-run planned {planned}; checks {check_s:.2f} s ({smi})")
    return {"summaries": summaries, "wall_s": wall, "equal": equal, "launches": launches,
            "warm_planned": planned, "cpu_render_s": ref_s, "check_s": check_s}


def module_probe() -> str:
    """Which optional third-party modules import here, with their
    versions. Printed for the record; phase 14's TestConfig needs yaml."""
    import importlib

    found = []
    for name in ("yaml", "pandas", "PIL", "matplotlib"):
        try:
            mod = importlib.import_module(name)
            found.append(f"{name} {getattr(mod, '__version__', '?')}")
        except ImportError as exc:
            found.append(f"{name} does not import ({exc})")
    return "; ".join(found)


class Phases:
    """The phase the smoke is in, so a failure can name it. `with
    phases(n, name):` logs the phase's start with its number and name, and
    its seconds at its end."""

    def __init__(self) -> None:
        self.current = (0, "start-up")
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @contextlib.contextmanager
    def __call__(self, n: int, name: str):
        self.current = (n, name)
        log(f"phase {n} ({name}): start at {self.elapsed():.1f} s")
        t0 = time.perf_counter()
        yield
        log(f"phase {n}: {time.perf_counter() - t0:.1f} s")


#: the phases `--phases` may run alone: each needs only the device and the
#: kernels built by phases 1 and 2
ALONE = (3, 7, 14, 15, 16, 17, 18)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=None,
                        help=f"comma-separated phases of {ALONE} to run after phases 1-2, "
                             "to find a fault (the result lines are printed only by a "
                             "run of every phase)")
    parser.add_argument("--steadiness", type=int, default=0, metavar="N",
                        help="run no phase: repeat phase 16's wall-clock gates N times")
    parser.add_argument("--against", action="append", default=[], metavar="DIR",
                        help="with --steadiness, also a checkout to run them from, in turns")
    args = parser.parse_args(argv)
    only = None
    if args.phases:
        only = sorted({int(v) for v in args.phases.split(",")})
        bad = [n for n in only if n not in ALONE]
        if bad:
            parser.error(f"--phases: {bad} cannot run alone (those that can: {ALONE})")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    phases = Phases()
    if args.steadiness:
        harness_steadiness(args.steadiness,
                           [ROOT] + [os.path.abspath(d) for d in args.against], device_line())
        return 0
    try:
        return run_smoke(phases, only)
    except Exception as exc:  # noqa: BLE001 - the boundary that names the failing phase
        traceback.print_exc()
        n, name = phases.current
        what = str(exc) if isinstance(exc, SmokeFailure) else f"{type(exc).__name__}: {exc}"
        what = " | ".join(ln.strip() for ln in what.splitlines() if ln.strip())
        print(f"chip_smoke: FAILED in phase {n} ({name}): {what[:4000]}", flush=True)
        return 1


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    # chainlint: disable=subprocess-hygiene (one read-only nvidia-smi query with a timeout; check=True fails the run)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_smoke(phases: Phases, only) -> int:
    """Phases 1-18 (or phases 1-2 and `only`), then the result lines."""
    dev = torch.device("cuda", 0)
    with phases(1, "device"):
        smi = device_line()
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        log(smi)
        t0 = time.perf_counter()
        log(f"libav: {medialib.version()} (io/medialib located, bound and checked it in "
            f"{time.perf_counter() - t0:.2f} s; phase 18 holds it)")
        log(f"python modules (information only): {module_probe()}")
    with phases(2, "build"):
        t0 = time.perf_counter()
        _build.build()
        log(f"build: {time.perf_counter() - t0:.2f} s")
        for name in _build.SOURCES:
            log(f"ptxas {name}.cu:\n{_build.ptxas_report(name).rstrip()}")
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    if only is not None:
        alone = {3: ("kernels against their plain versions", lambda: check_kernels(dev)),
                 7: ("the downstream render", lambda: run_downstream_both(dev)),
                 14: ("the database", lambda: run_database(dev, workdir)),
                 15: ("the serve control plane", lambda: run_control(dev, workdir)),
                 16: ("the proof harnesses", lambda: run_harness(dev, smi)),
                 17: ("the port's gates", lambda: run_gates(dev, workdir, smi)),
                 18: ("the media boundary and p03's file path",
                      lambda: run_media(dev, smi))}
        for n in only:
            with phases(n, alone[n][0]):
                alone[n][1]()
        log(f"chip_smoke: phases 1, 2 and {only} passed; a run of a subset prints no result")
        return 0

    with phases(3, "kernels against their plain versions"):
        err = check_kernels(dev)
    with phases(4, "the p03 device seam"):
        main8 = run_main_path(dev, CLIP_FRAMES, "yuv420p", workdir)
        main10 = run_main_path(dev, CLIP_FRAMES_10BIT, "yuv420p10le", workdir)
    with phases(5, "the flagship step"):
        flagship = run_flagship(dev)
    with phases(6, "the wave render"):
        waves = {label: run_wave(dev, label, lengths, four, workdir)
                 for label, lengths, four in WAVE_CASES}
        log(f"wave render (production mesh): {waves['production']['frames_per_s']:.2f} "
            f"frames/s beside pump_ready {main8['frames_per_s']:.2f} frames/s, same run")
    with phases(7, "the downstream render"):
        downstream = run_downstream_both(dev)
    with phases(8, "kernel timing"):
        timing = time_kernels(dev)
    with phases(9, "p01's quality ladder"):
        sources = ladder_sources()
        ladder = {}
        for label, source, width, fps_spec, pix_fmt in LADDER_RUNS:
            chunks, src_h, src_w = sources[source]
            ladder[label] = run_ladder(dev, label, chunks, src_h, src_w, width, fps_spec,
                                       pix_fmt)
    with phases(10, "the quality tools"):
        quality = {"u8": run_quality(dev, "u8", CLIP_FRAMES, "yuv420p"),
                   "10bit": run_quality(dev, "10-bit", CLIP_FRAMES_10BIT, "yuv420p10le")}
        src_summary = {"2160p": run_src_analysis(dev, "2160p", sources["2160p"][0]),
                       "2160p10": run_src_analysis(dev, "2160p10", sources["2160p10"][0])}
        del sources
        priors = run_priors(dev)
    with phases(11, "the serve path"):
        serve = run_serve(dev, workdir)
        err["siti_frames_fused_batch"] = max(err["siti_frames_fused_batch"],
                                             serve["siti_batch_max_err"])
    with phases(12, "the (pvs, time) mesh"):
        mesh = run_mesh(dev, workdir)
    with phases(13, "the profiling plane"):
        profiled = run_profiled(dev, workdir, waves["production"], main8, timing)
        profiled["serve"] = serve.pop("observed")
    with phases(14, "the database"):
        database = run_database(dev, workdir)
    with phases(15, "the serve control plane"):
        control = run_control(dev, workdir)
    with phases(16, "the proof harnesses"):
        harness = run_harness(dev, smi)
    with phases(17, "the port's gates"):
        gates = run_gates(dev, workdir, smi)
    with phases(18, "the media boundary and p03's file path"):
        media = run_media(dev, smi)

    phases.current = (19, "the result lines")
    total = phases.elapsed()
    paths = {"pump_ready_u8": main8["launches"], "pump_ready_10bit": main10["launches"],
             **{k: v["launches"] for k, v in flagship.items()},
             **{f"wave_{k}": v["launches"] for k, v in waves.items()},
             **{f"downstream_{k}": v["launches"] for k, v in downstream.items()},
             **{f"staged_stall_{k}": v["staged_launches"] for k, v in downstream.items()},
             **{f"p01_ladder_{k}": v["launches"] for k, v in ladder.items()},
             **{f"quality_metrics_{k}": v["launches"] for k, v in quality.items()},
             **{f"src_analysis_{k}": v["launches"] for k, v in src_summary.items()},
             "serve_wave": serve["launches"],
             "serve_control": control["launches"],
             "serve_soak": harness["launches"],
             "serve_gates": gates["recorders"]["launches"],
             **{f"mesh_wave_{k}": v["launches"] for k, v in mesh["waves"]["runs"].items()},
             "mesh_sharded_step": mesh["sharded_step"]["launches"],
             **{f"db_{k}": v["launches"] for k, v in database["pvses"].items()},
             "p03_file": media["launches"], "p03_file_10bit": media["launches_10bit"],
             "p03_file_long": media["launches_long"], "p04_file": media["launches_p04"],
             "p03_file_fused": media["launches_fused"], "p01_file": media["launches_p01"]}
    if media["launches_p00"] is not None:  # no p00 process where no encoder of the four opens
        paths["p00_file"] = media["launches_p00"]
    # each kernel's `launches` is read from the path it was ported for
    home = {"resize_frames_fused": "pump_ready_u8", "si_frames_fused": "pump_ready_u8",
            "ti_frames_fused": "pump_ready_u8", "siti_frames_fused": "flagship",
            "siti_frames_fused_batch": "wave_production"}
    per_chunk = {"resize_frames_fused": 3, "si_frames_fused": 1, "ti_frames_fused": 1,
                 "siti_frames_fused": 1, "siti_frames_fused_batch": 1}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        require(paths[home[name]][name] > 0, f"{name}: no launch on {home[name]}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"processing_chain_tpu_torch/{source}",
            "replaces": f"processing_chain_tpu/ops/{replaces}",
            "launches": paths[home[name]][name],
            "launches_path": home[name],
            "launches_per_chunk": per_chunk[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": err[name], "matches_plain": True,
            **timing[name],
        })
    log(json.dumps({"main_path": [main8, main10], "flagship": flagship,
                    "waves": waves, "downstream": downstream, "p01_ladder": ladder,
                    "quality": quality, "src_analysis": src_summary, "priors": priors,
                    "serve": serve, "mesh": mesh, "profiled": profiled, "database": database,
                    "control": control, "harness": harness, "gates": gates,
                    "media": media, "card": smi}))
    log(f"chip_smoke: phases 1-18 in {total:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
