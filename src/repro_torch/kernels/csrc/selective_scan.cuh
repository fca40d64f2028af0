// What the scan's forward (csrc/selective_scan.cu) and backward
// (csrc/selective_scan_bwd.cu) share: the backward's run, the time steps
// it recomputes into registers and walks back at a time, which is also
// the stride at which the forward's training variant keeps h.  64
// registers of a_t, h_t a thread (8 steps x 4 states x 2); a run's a_t,
// h_t in shared memory instead (2 blocks an SM at 16 steps) ran 1.2-1.6x
// slower (PERF.md §6).
#pragma once

namespace scan {
constexpr int STATE_RUN = 8;
}  // namespace scan
