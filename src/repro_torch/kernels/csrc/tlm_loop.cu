// The TLM's event loop for the paper's program, a whole run a lane in one
// launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the XLA program that the
// reference's event loop compiles to: the lax.while_loop of
// src/repro/core/sim.py:simulate (sim.py:1286-1557), jitted as sim._run and
// vmapped over lanes by core/sweep.py.  The port's host loops
// (core/sim.simulate_host, core/lanes.simulate_lanes_host) are its plain
// version: they launch a handful of torch ops an event and read one packed
// record back to the host an event (or a lane step).  Here each lane's run
// stays on the card from its first pop to its empty queue.
//
// The program it covers (kernels/tlm_loop.py:covers): the ideal fabric,
// the linear queue, mapping min_search, beacons on the threshold rule, no
// faults, no trace, no record_s1.  Three event types: ARRIVE (stage 1: the
// fork tree at the arrival GMN, ns own-first argmins over its view row,
// one LOCAL_SPAWN a target, a unicast over the global bus for each remote
// one), LOCAL_SPAWN (stage 2: cnt argmins over the cluster's PE loads,
// each task-start over the cluster's local bus, one JOIN_EXIT a child,
// then the beacon check) and JOIN_EXIT (the join-exit message, the load
// decrement, the beacon check, the forward to the barrier GMN and the
// barrier decrement).  A beacon on the ideal fabric updates every view
// atomically at its bus grant, so no BEACON_RX event exists.
//
// Bits.  Every f32 operation is the host loop's, in its order, rounded
// once: additions, subtractions and products are __fadd_rn / __fsub_rn /
// __fmul_rn, which nvcc never contracts into an FMA (an FMA would change
// app_done's bits).  Products with host constants take the host's f32
// value: the fork tree's 2*depth (one float, then times sel_global, the
// traced c_s * log2(k)) and k-1 of a beacon's latency.  torch.maximum is
// `tmax` (NaN wins, else the larger, the first on a tie).  Argmins follow
// torch.argmin: a NaN first, then the least value, ties to the lower
// index; the own-first argmin of min_search ranks index j as (j - g) mod k.
// The pop takes the first minimal slot, and a push takes the first free
// slot (ev_time >= INF) after the pop, so the j-th event a handler pushes
// lands in the j-th free slot, as sim._bulk_push does: slot order decides
// which of two simultaneous events runs first.  Only mgmt_latency may
// differ: the host adds a handler's latencies as one vector sum
// (lats.sum()), this kernel from left to right.  The int32 counters
// (events_processed, beacons_tx, mgmt_msgs, evq_len, evq_peak, dropped)
// are exact.
//
// Layout: one block of one warp a lane.  The pop is a warp argmin over
// ev_time[0, hi), where hi is one past the highest slot ever written (the
// slots above it are free, INF); a push is a ballot over 32 slots at a
// time from the commit's cursor.  The handler's scalar work is computed
// by every thread alike (the same values in every register), and thread
// 0 writes it, with a __syncwarp before the write (every thread has read)
// and after it (every thread sees it).  The rows a handler walks many
// times (the deciding GMN's view row, the cluster's loads and PE free
// times) sit in shared memory for the handler; the stage-2 PE choice and
// the row sums are warp reductions.  The rest of the state stays where
// sim.make_state put it, in device memory, read and written in place with
// a leading lane axis: view is (k, k) int32, 256 KB a lane at k = 256,
// which shared memory could not hold.  The lanes of a launch run side by
// side on the SMs.
//
// What bounds it: the serial chain of one lane's events.  An event
// depends on every event before it (the queue, the buses, the loads), so
// a lane is one chain of dependent warp reductions and L2 round trips:
// the pop's scan of hi/32 slots a thread and its 5-step shuffle argmin,
// then the handler's ns or cnt argmins of 5 shuffle steps each.  The bytes
// the run must move (each leaf read once, written once) take microseconds
// at 3.35 TB/s and the arithmetic less; the time is the chain's latency,
// microseconds an event, times the events of the longest lane.  Tensor
// cores, TMA and deeper pipelines have nothing to work on: there is no
// product and nothing to prefetch but the next event, which waits for
// this one.
//
// The run stops at an events ceiling from the wrapper (the arrivals times
// the most events one application causes, 1 + ns + n_childs): a lane that
// reaches it with events left writes status 1, and an event type outside
// the program status 2, so a fault ends in an exception, never in a hang.

#include <cuda_runtime.h>

namespace tlm {

constexpr float INF = 1e18f;   // the reference's jnp.float32(1e18)
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int EV_ARRIVE = 0, EV_LOCAL_SPAWN = 1, EV_JOIN_EXIT = 2;
constexpr int N_PTRS = 30;
constexpr int MAX_SMEM = 48 * 1024;

// Device pointers, each leaf with a leading lane axis (kernels/tlm_loop.py:
// LEAVES, then INPUTS, in this order).
struct Lanes {
  float* ev_time;            // (L, Q)
  int* ev_type;              // (L, Q)
  int* ev_a;                 // (L, Q, 3)
  float* pe_free;            // (L, k, mpk)
  float* gmn_free;           // (L, k)
  float* gbus_free;          // (L,)
  float* lbus_free;          // (L, k)
  int* loads;                // (L, k, mpk)
  int* view;                 // (L, k, k)
  float* view_t;             // (L, k, k)
  int* last_bcast;           // (L, k)
  float* last_bcast_t;       // (L, k)
  int* rr_ptr;               // (L, k)
  int* beacons_tx;           // (L,)
  int* mgmt_msgs;            // (L,)
  float* mgmt_latency;       // (L,)
  float* mgmt_proc;          // (L,)
  int* app_remaining;        // (L, A)
  float* app_arrive;         // (L, A)
  float* app_done;           // (L, A)
  int* events_processed;     // (L,)
  int* dropped;              // (L,)
  int* evq_len;              // (L,)
  int* evq_peak;             // (L,)
  const float* lengths;      // (L, A, n_childs)
  const int* parent;         // (L, A): each application's barrier GMN
  const float* knobs;        // (L, 4): c_b, c_join, sel_global, sel_local
  const int* dn_th;          // (L,)
  const int* cnts;           // (ns,): the children of each stage-1 target
  int* status;               // (L,): 0 done, 1 ceiling reached, 2 bad type
};

struct Dims {
  int lanes, Q, k, mpk, A, n_childs, ns;
  float tree_mul;            // 2 * depth of the fork tree, as one f32
  float lat_k1;              // k - 1, as one f32
  long long max_events;      // the events ceiling of a lane
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// torch.maximum: a NaN if either is one, else the larger, the first on a
// tie (-0.0 against +0.0)
__device__ __forceinline__ float tmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

// (a, ia) before (b, ib) in torch.argmin's order: a NaN first, then the
// least value, ties to the lower index
__device__ __forceinline__ bool f_before(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ bool i_before(int a, int ia, int b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Every thread's (value, index) to the warp's first in that order, in
// every thread (the order is total, so the butterfly agrees).
__device__ __forceinline__ void argmin_f(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (f_before(v2, i2, v, i)) { v = v2; i = i2; }
  }
}

__device__ __forceinline__ void argmin_i(int& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (i_before(v2, i2, v, i)) { v = v2; i = i2; }
  }
}

__device__ __forceinline__ int sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sum of a row of n int32 values (the loads of a cluster), in every thread.
__device__ __forceinline__ int row_sum(const int* row, int n) {
  int s = 0;
  for (int j = threadIdx.x; j < n; j += 32) s += row[j];
  return sum_i(s);
}

// A lane's linear queue: its slots, one past the highest slot ever
// written (`hi`), and the cursor of the commit in progress (the first
// slot a push may take).
struct Queue {
  float* time;
  int* type;
  int* a;
  int Q, hi, cur;

  // Push one event into the first free slot at or after the cursor;
  // false (dropped) when the queue is full.
  __device__ bool push(float t, int typ, int a0, int a1, int a2) {
    const int tid = threadIdx.x;
    int slot = -1;
    for (int base = cur & ~31; base < hi; base += 32) {
      const int s = base + tid;
      const bool free_s = s >= cur && s < hi && time[s] >= INF;
      const unsigned m = __ballot_sync(FULL, free_s);
      if (m != 0u) {
        slot = base + __ffs(m) - 1;
        break;
      }
    }
    if (slot < 0) {
      slot = cur > hi ? cur : hi;          // every slot from hi on is free
      if (slot >= Q) return false;
    }
    __syncwarp();
    if (tid == 0) {
      time[slot] = t;
      type[slot] = typ;
      a[3 * slot] = a0;
      a[3 * slot + 1] = a1;
      a[3 * slot + 2] = a2;
    }
    __syncwarp();
    cur = slot + 1;
    if (hi < cur) hi = cur;
    return true;
  }
};

__global__ void __launch_bounds__(32) run_lanes(Lanes s, Dims d) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x;
  const int run = blockIdx.x;
  const int Q = d.Q, k = d.k, mpk = d.mpk, A = d.A;
  int* vrow = smem;                                    // (k,) a view row
  int* lrow = smem + k;                                // (mpk,) loads
  float* frow = reinterpret_cast<float*>(smem + k + mpk);  // (mpk,) PE free

  const size_t rk = static_cast<size_t>(run) * k;
  const size_t rkk = rk * k, rkm = rk * mpk, ra = static_cast<size_t>(run) * A;
  Queue q{s.ev_time + static_cast<size_t>(run) * Q,
          s.ev_type + static_cast<size_t>(run) * Q,
          s.ev_a + static_cast<size_t>(run) * Q * 3, Q, 0, 0};
  float* pe_free = s.pe_free + rkm;
  float* gmn_free = s.gmn_free + rk;
  float* lbus_free = s.lbus_free + rk;
  int* loads = s.loads + rkm;
  int* view = s.view + rkk;
  float* view_t = s.view_t + rkk;
  int* last_bcast = s.last_bcast + rk;
  float* last_bcast_t = s.last_bcast_t + rk;
  int* rr_ptr = s.rr_ptr + rk;
  int* app_remaining = s.app_remaining + ra;
  float* app_arrive = s.app_arrive + ra;
  float* app_done = s.app_done + ra;
  const float* lengths = s.lengths + ra * d.n_childs;
  const int* parent = s.parent + ra;
  const float c_b = s.knobs[4 * run], c_join = s.knobs[4 * run + 1];
  const float sel_global = s.knobs[4 * run + 2];
  const float sel_local = s.knobs[4 * run + 3];
  const int dn_th = s.dn_th[run];

  // the scalar leaves, in registers for the run
  float gbus = s.gbus_free[run];
  float lat = s.mgmt_latency[run], proc = s.mgmt_proc[run];
  int beacons = s.beacons_tx[run], msgs = s.mgmt_msgs[run];
  int events = s.events_processed[run], dropped = s.dropped[run];
  int evq_len = s.evq_len[run], evq_peak = s.evq_peak[run];
  int status = 0;

  // hi: one past the last slot _init_queue filled
  int last = -1;
  for (int j = tid; j < Q; j += 32)
    if (!(q.time[j] >= INF)) last = j;
  for (int o = 16; o > 0; o >>= 1) {
    const int l2 = __shfl_xor_sync(FULL, last, o);
    last = l2 > last ? l2 : last;
  }
  q.hi = last + 1;

  // The beacon check of GMN g at tick tb with its load sum (Sec 4.2:
  // threshold rule, k > 1), on the ideal fabric: serialize on the global
  // bus, every receiver's view of g updated at the grant.
  auto beacon = [&](int g, float tb, int load_g) {
    if (k == 1) return;
    const int diff = load_g - last_bcast[g];
    if ((diff < 0 ? -diff : diff) < dn_th) return;
    const float t_tx = add(tmax(tb, gbus), c_b);
    gbus = t_tx;
    __syncwarp();
    for (int j = tid; j < k; j += 32) {
      view[static_cast<size_t>(j) * k + g] = load_g;
      view_t[static_cast<size_t>(j) * k + g] = t_tx;
    }
    if (tid == 0) {
      last_bcast[g] = load_g;
      last_bcast_t[g] = t_tx;
    }
    __syncwarp();
    beacons += 1;
    msgs += k - 1;
    lat = add(lat, mul(d.lat_k1, sub(t_tx, tb)));
  };

  long long n_run = 0;
  for (;;) {
    // pop: the first minimal slot
    float t = INF;
    int slot = IMAX;
    for (int j = tid; j < q.hi; j += 32) {
      const float v = q.time[j];
      if (f_before(v, j, t, slot)) {
        t = v;
        slot = j;
      }
    }
    argmin_f(t, slot);
    if (t >= INF) break;
    if (n_run == d.max_events) {
      status = 1;
      break;
    }
    ++n_run;
    // the occupancy high-water mark, sampled before the pop
    if (evq_peak < evq_len) evq_peak = evq_len;
    events += 1;
    const int typ = q.type[slot];
    const int a0 = q.a[3 * slot], a1 = q.a[3 * slot + 1];
    const int a2 = q.a[3 * slot + 2];
    __syncwarp();
    if (tid == 0) q.time[slot] = INF;
    __syncwarp();
    evq_len -= 1;
    q.cur = 0;

    if (typ == EV_ARRIVE) {
      // stage 1 at GMN g: the fork tree, then one target a LOCAL_SPAWN
      const int app = a0, g = a1;
      const float t_cpu = tmax(t, gmn_free[g]);
      const float t_tree = add(t_cpu, mul(d.tree_mul, sel_global));
      const int load_g = row_sum(loads + static_cast<size_t>(g) * mpk, mpk);
      for (int j = tid; j < k; j += 32)
        vrow[j] = j == g ? load_g : view[static_cast<size_t>(g) * k + j];
      const int rr = rr_ptr[g];
      __syncwarp();
      float lat_sum = 0.0f;
      for (int i = 0; i < d.ns; ++i) {
        int bv = IMAX, br = IMAX;             // value, rank from g
        for (int j = tid; j < k; j += 32) {
          const int r = j >= g ? j - g : j - g + k;
          if (i_before(vrow[j], r, bv, br)) {
            bv = vrow[j];
            br = r;
          }
        }
        argmin_i(bv, br);
        const int c = br + g >= k ? br + g - k : br + g;
        const int cnt = s.cnts[i];
        __syncwarp();
        if (tid == 0) vrow[c] += cnt;
        __syncwarp();
        float t_arr = t_tree, l_i = 0.0f;
        if (c != g) {
          t_arr = add(tmax(t_tree, gbus), c_b);
          gbus = t_arr;
          l_i = sub(t_arr, t_tree);
          msgs += 1;
        }
        lat_sum = add(lat_sum, l_i);
        if (q.push(t_arr, EV_LOCAL_SPAWN, app, c, cnt)) evq_len += 1;
        else dropped += 1;
      }
      lat = add(lat, lat_sum);
      proc = add(proc, sub(t_tree, t));
      __syncwarp();
      for (int j = tid; j < k; j += 32)
        view[static_cast<size_t>(g) * k + j] = vrow[j];
      if (tid == 0) {
        gmn_free[g] = t_tree;
        rr_ptr[g] = rr + d.ns;
        app_remaining[app] = d.n_childs;
        app_arrive[app] = t;
      }
      __syncwarp();
    } else if (typ == EV_LOCAL_SPAWN) {
      // stage 2 at GMN g: cnt children onto the cluster's PEs
      const int app = a0, g = a1, cnt = a2;
      float t_cpu = tmax(t, gmn_free[g]);
      float bus = lbus_free[g];
      int* loads_g = loads + static_cast<size_t>(g) * mpk;
      float* free_g = pe_free + static_cast<size_t>(g) * mpk;
      for (int j = tid; j < mpk; j += 32) {
        lrow[j] = loads_g[j];
        frow[j] = free_g[j];
      }
      __syncwarp();
      const float* len = lengths + static_cast<size_t>(app) * d.n_childs;
      float lat_sum = 0.0f;
      for (int i = 0; i < cnt; ++i) {
        t_cpu = add(t_cpu, sel_local);
        int bv = IMAX, pe = IMAX;
        for (int j = tid; j < mpk; j += 32)
          if (i_before(lrow[j], j, bv, pe)) {
            bv = lrow[j];
            pe = j;
          }
        argmin_i(bv, pe);
        const float t_msg = add(tmax(t_cpu, bus), c_b);
        bus = t_msg;
        const float finish = add(tmax(t_msg, frow[pe]), len[i]);
        __syncwarp();
        if (tid == 0) {
          frow[pe] = finish;
          lrow[pe] += 1;
        }
        __syncwarp();
        lat_sum = add(lat_sum, sub(t_msg, t_cpu));
        if (q.push(finish, EV_JOIN_EXIT, app, g, pe)) evq_len += 1;
        else dropped += 1;
      }
      for (int j = tid; j < mpk; j += 32) {
        loads_g[j] = lrow[j];
        free_g[j] = frow[j];
      }
      const int load_g = row_sum(lrow, mpk);
      __syncwarp();
      if (tid == 0) {
        gmn_free[g] = t_cpu;
        lbus_free[g] = bus;
      }
      __syncwarp();
      msgs += cnt;
      lat = add(lat, lat_sum);
      proc = add(proc, sub(t_cpu, t));
      beacon(g, t_cpu, load_g);
    } else if (typ == EV_JOIN_EXIT) {
      // a child finished on PE pe of cluster g
      const int app = a0, g = a1, pe = a2;
      const float t_msg = add(tmax(t, lbus_free[g]), c_b);
      const int pg = parent[app];
      __syncwarp();
      if (tid == 0) {
        lbus_free[g] = t_msg;
        loads[static_cast<size_t>(g) * mpk + pe] -= 1;
      }
      __syncwarp();
      msgs += 1;
      lat = add(lat, sub(t_msg, t));
      // the beacon's bus grant comes before the forward's
      beacon(g, t_msg, row_sum(loads + static_cast<size_t>(g) * mpk, mpk));
      float t_fwd = t_msg;
      if (pg != g) {
        t_fwd = add(tmax(t_msg, gbus), c_b);
        gbus = t_fwd;
        msgs += 1;
        lat = add(lat, sub(t_fwd, t_msg));
      }
      const float t_bar = add(tmax(t_fwd, gmn_free[pg]), c_join);
      proc = add(proc, sub(t_bar, t_fwd));
      const int rem = app_remaining[app] - 1;
      __syncwarp();
      if (tid == 0) {
        gmn_free[pg] = t_bar;
        app_remaining[app] = rem;
        if (rem == 0) app_done[app] = t_bar;
      }
      __syncwarp();
    } else {
      status = 2;
      break;
    }
  }

  if (tid == 0) {
    s.gbus_free[run] = gbus;
    s.mgmt_latency[run] = lat;
    s.mgmt_proc[run] = proc;
    s.beacons_tx[run] = beacons;
    s.mgmt_msgs[run] = msgs;
    s.events_processed[run] = events;
    s.dropped[run] = dropped;
    s.evq_len[run] = evq_len;
    s.evq_peak[run] = evq_peak;
    s.status[run] = status;
  }
}

}  // namespace tlm

extern "C" {

// The dynamic shared memory a launch takes at (k, mpk): a view row, a
// loads row and a PE free-time row.
int tlm_loop_smem_bytes(int k, int mpk) { return 4 * (k + 2 * mpk); }

// Run every lane's event loop to its empty queue (or its ceiling) in one
// launch: `ptrs` holds the N_PTRS device pointers of tlm::Lanes in its
// order, `dims` (lanes, queue_cap, k, mpk, max_apps, n_childs, ns).  The
// state is updated in place; `status` says how each lane ended.
// Launched on `stream`; returns the launch's cudaError_t (0 = launched).
int tlm_loop(void* const* ptrs, int n_ptrs, const int* dims, float tree_mul,
             float lat_k1, long long max_events, void* stream) {
  if (n_ptrs != tlm::N_PTRS) return cudaErrorInvalidValue;
  tlm::Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6],
              tree_mul, lat_k1, max_events};
  if (d.lanes < 1 || d.Q < 1 || d.k < 1 || d.mpk < 1 || d.A < 1 ||
      d.n_childs < 1 || d.ns < 1 || d.ns > d.k || max_events < 0)
    return cudaErrorInvalidValue;
  const int smem = tlm_loop_smem_bytes(d.k, d.mpk);
  if (smem > tlm::MAX_SMEM) return cudaErrorInvalidValue;
  tlm::Lanes s{
      static_cast<float*>(ptrs[0]), static_cast<int*>(ptrs[1]),
      static_cast<int*>(ptrs[2]), static_cast<float*>(ptrs[3]),
      static_cast<float*>(ptrs[4]), static_cast<float*>(ptrs[5]),
      static_cast<float*>(ptrs[6]), static_cast<int*>(ptrs[7]),
      static_cast<int*>(ptrs[8]), static_cast<float*>(ptrs[9]),
      static_cast<int*>(ptrs[10]), static_cast<float*>(ptrs[11]),
      static_cast<int*>(ptrs[12]), static_cast<int*>(ptrs[13]),
      static_cast<int*>(ptrs[14]), static_cast<float*>(ptrs[15]),
      static_cast<float*>(ptrs[16]), static_cast<int*>(ptrs[17]),
      static_cast<float*>(ptrs[18]), static_cast<float*>(ptrs[19]),
      static_cast<int*>(ptrs[20]), static_cast<int*>(ptrs[21]),
      static_cast<int*>(ptrs[22]), static_cast<int*>(ptrs[23]),
      static_cast<const float*>(ptrs[24]), static_cast<const int*>(ptrs[25]),
      static_cast<const float*>(ptrs[26]), static_cast<const int*>(ptrs[27]),
      static_cast<const int*>(ptrs[28]), static_cast<int*>(ptrs[29])};
  tlm::run_lanes<<<d.lanes, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      s, d);
  return cudaGetLastError();
}

}  // extern "C"
