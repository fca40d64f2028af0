"""Static-analysis passes over the port's source and what its loops
dispatch (port of ``repro/analysis``).

Three contracts, one CLI (``python -m repro_torch.analysis``):

  loop_copy     — a lane step of the event loop copies nothing that
                  scales with queue_cap or (k,k) (DESIGN.md §11 as a
                  checked invariant): the ops a step dispatches under a
                  ``TorchDispatchMode``, and on the card its copy kernels
                  under ``torch.profiler``; the counterpart of the
                  reference's HLO loop-body lint.
  lint          — no host sync or host call on the event loops' path in
                  src/repro_torch/core + src/repro_torch/serving but the
                  one packed read an event or a step; gated features
                  (trace/faults/detector) are absent from the OFF
                  programs (gate purity).
  scatter_check — the fused commit chains (tree, calendar, trace ring)
                  and the loops' other indexed writes write pairwise
                  disjoint positions or identical values, and nothing
                  reads the queues' scratch row.

The port has no HLO, so the reference's ``hlo_text`` parser has no
counterpart (``launch/op_cost`` stands in for its op costs).
"""
