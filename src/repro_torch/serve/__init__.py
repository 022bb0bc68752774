"""Serving on the port.

* **DecodeServeEngine** (engine.py) serves *model decode*: continuous
  batching of LLM requests into fixed decode slots, with a paged KV page
  allocator on the host (paged_kv.py). `ServeEngine` is the same class
  under the reference's older name.
* **JoinServeEngine** (join_engine.py) serves *join queries*: concurrent
  tenants' queries are canonicalized into plan templates
  (templates.canonicalize: alias alpha-renaming + constant lifting),
  co-template requests are dispatched as one batched call over shared
  cached tries (on seeded lanes for point queries, else in mask mode),
  and admission control (admission.py) rejects
  quota-violating queries instead of letting them trigger growth storms.
  Recoverable faults walk a degradation ladder down to the eager engine
  on the same device.
* **StandingQueryEngine** (standing.py) keeps registered join queries
  *answered* as base relations mutate through the relcache delta API
  (`append`/`delete`): each refresh recomputes only the plan stages whose
  input fingerprints moved (delta-merged tries from the versioned trie
  cache), replaying cached device buffers for the rest.
* **canonicalize** / **PlanTemplate** (templates.py) map alpha-equivalent
  spellings of one query, with their selection constants lifted out, to
  one template key, so they share runners.
"""
from repro_torch.serve.admission import AdmissionController, AdmissionError, QueryQuota
from repro_torch.serve.engine import DecodeServeEngine, Request, ServeEngine
from repro_torch.serve.join_engine import JoinRequest, JoinServeEngine
from repro_torch.serve.paged_kv import PagedAllocator
from repro_torch.serve.standing import StandingQuery, StandingQueryEngine
from repro_torch.serve.templates import PlanTemplate, canonicalize

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "DecodeServeEngine",
    "JoinRequest",
    "JoinServeEngine",
    "PagedAllocator",
    "PlanTemplate",
    "QueryQuota",
    "Request",
    "ServeEngine",
    "StandingQuery",
    "StandingQueryEngine",
    "canonicalize",
]
