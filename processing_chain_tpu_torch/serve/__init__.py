"""chain-serve: the always-on processing service (port of
processing_chain_tpu/serve/).

    api.py        request grammar and grid expansion into per-PVS units
    queue.py      durable, dedup-aware job queue (one atomic JSON record
                  per job, lease-fenced, plan-hash attachment)
    spans.py      the queue's per-replica span journal
    scheduler.py  worker threads: stride-scheduled fairness, singleflight
                  claims, cross-request wave packing through JobRunner
    executors.py  the Executor protocol, the synthetic toy executor and
                  the device-wave executor over parallel/p03_batch
    pressure.py   serve-side LRU pressure driving store/gc with the
                  plans of unfinished requests pinned
    cost.py       the predicted-cost model, the cost ledger and
                  admission control
    autoscale.py  the scale signal graded from backlog and alerts
    service.py    the daemon: all of the above on one LiveServer

Entry point: `python -m processing_chain_tpu_torch tools chain-serve`
(tools/chain_serve.py).
"""

from .api import RequestError, validate_request  # noqa: F401
from .service import ChainServeService  # noqa: F401
