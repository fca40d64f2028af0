"""Frozen reference digests, and the port's runs that reproduce them.

The constants are what the JAX reference computes (held against it by
tests/test_torch_sim.py), so the card can be checked against them
without JAX (``chip_smoke.py``):

- the golden grid of ``tests/test_sweep.py``: m=16, k=4, n_childs=16,
  max_apps=32, queue_cap=512, interference seeds (0, 1) at sim_len 3e5,
  dn_th in (1, 2, 4, 8) — ``beacons_tx`` per (dn_th, seed) and the
  sha256 of the stacked (4, 2, 32) f32 ``app_done``;
- its single-application anchor (``independent_tasks``, sim_len 1e7);
- the paper point: ``SimParams()`` defaults (m=256, k=16, n_childs=100,
  max_apps=512, queue_cap=2048, dn_th=4) under ``interference`` seed 1,
  at the paper's horizon 4e6 and at 1e6;
- the fig3b spot grid of ``tests/test_sweep.py``: m=64, k=16,
  n_childs=50, max_apps=128, queue_cap=2048, interference seed 1 at
  sim_len 1e6, dn_th in (1, 2, 4, 8, 16, 32) — ``beacons_tx`` (6, 1) and
  the sha256 of the (6, 1, 128) f32 ``app_done``;
- Table 5 at the paper's widths (m=256, n_childs=100, max_apps=512,
  queue_cap=2048, dn_th=4, k in (1, 8, 16, 256), interference seeds
  (1, 2, 3)) cut to sim_len 2.5e5: per k, ``beacons_tx`` and
  ``events_processed`` per seed, the ``app_done`` sha256 and each lane's
  speedup as the bits of its float32 value (:func:`table5_digest`);
- the paper tier of ``benchmarks/topology_frontier.py`` on every fabric
  (m=256, n_childs=100, max_apps=64, queue_cap=8192, c_s=8, dn_th=4,
  interference seeds (1, 2) at pair_period 14,000, k in (16, 32), the
  linear queue) at sim_len 1e6, at 2.5e5 (34 of the 64 applications;
  every one arrives before 4.5e5, so 5e5 would cut nothing) and at 1e5,
  the card's horizons: per (k, fabric) the per-seed
  ``events_processed``, ``beacons_tx``, ``beacons_rx``, ``evq_peak``,
  ``dropped`` and ``mgmt_latency``, and the ``app_done`` sha256
  (:func:`fabric_digest`);
- the two cut points of that tier (the same widths, knobs, seeds and
  stimulus): k=1 on the linear queue (queue_cap 8,192) on ``ideal`` at
  sim_len 2.5e5, and k=256 with the tier's 32,768-slot tree queue and
  ``batch_pop`` 64 on ``hier_tree`` and ``mesh2d`` at 2.5e5 and at 1e5,
  the card's fallback (:func:`cut_digest`, keyed as FABRICS);
- the fault groups of the card's phase ``faults`` (:func:`fault_specs`:
  the tier above at k=16 on the linear queue, sim_len 1e5, under no
  fault, Poisson link failures, a partition and GMN churn on
  ``hier_tree``, the partition on ``mesh2d``, and the detector tier
  under a manager outage): per group the per-seed counters, the
  fault and detector counters and the ``app_done`` sha256
  (:func:`fault_digests`);
- the trace leaves of the card's phase ``trace`` (trace_report's
  TraceSpec: ring 16,384, stride 64, 512 samples, 64 bins, 4 per
  octave): the paper point at sim_len 1e6 through ``sim.run``; the
  tier above at k=16 on ``hier_tree`` (linear queue, seeds 1-2) at 1e5;
  and k=16 ``hier_tree`` on the tree queue with ``batch_pop`` 64 under
  a partition at 2e4 with a 1,024-row ring that overflows
  (:func:`trace_runs`, :func:`trace_digest`);
- the result of ``launch.serve.serve(cfg)`` with its
  default arguments (64 requests, 4 clusters of 2 groups, dn_th 4, seed
  0): it depends on the control plane only, so it holds for any model
  config, dtype and device (held against the reference by
  tests/test_torch_serve.py).
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core import metrics as M
from repro_torch.core import workloads as W
from repro_torch.core.sim import SimParams, run

GRID_PARAMS = dict(m=16, k=4, n_childs=16, max_apps=32, queue_cap=512)
GRID_DN_TH = (1, 2, 4, 8)
GRID_SEEDS = (0, 1)
GRID_SIM_LEN = 3e5
GRID_BEACONS = [[600, 600], [351, 360], [202, 232], [72, 78]]
GRID_APP_DONE_SHA = \
    "72576e858be248d11e21055618ff6a1aba89ebd7f7f4ea3419d9384b59cd3efa"
SINGLE_APP_DONE = 16240.0
SINGLE_APP_BEACONS = 8

FIG3B_PARAMS = dict(m=64, k=16, n_childs=50, max_apps=128, queue_cap=2048)
FIG3B_DN_TH = (1, 2, 4, 8, 16, 32)
FIG3B_SEED = 1
FIG3B_SIM_LEN = 1e6
FIG3B_BEACONS = [[7178], [4254], [2224], [766], [297], [144]]
FIG3B_APP_DONE_SHA = \
    "aabc517cabec6be6779f643aad59e0294c19eb29d2799a0eb8484beb88ab1cf2"

TABLE5_KS = (1, 8, 16, 256)
TABLE5_SEEDS = (1, 2, 3)
TABLE5_SIM_LEN = 2.5e5     # cut for the card script's time limit
TABLE5_PARAMS = dict(m=256, n_childs=100, max_apps=512, queue_cap=2048)
# The JAX reference's run of that spec on the CPU (seq mode), made by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.experiment
#   import ExperimentSpec, WorkloadSpec; from repro.core.sim import
#   SimParams; from repro_torch.core import goldens as G; print(
#   G.table5_digest(ExperimentSpec(base=SimParams(**G.TABLE5_PARAMS),
#   shapes=G.TABLE5_KS, knobs={'dn_th': 4}, workloads=(WorkloadSpec(
#   'interference', seeds=G.TABLE5_SEEDS),), sim_len=G.TABLE5_SIM_LEN)
#   .run()))"
TABLE5 = {
    1: {"beacons_tx": [0, 0, 0],
        "events_processed": [3264, 3264, 3264],
        "app_done_sha": "349eb8b6923278d5b55db43a1aa3a03a"
                        "9039c0d5244e54b3b2d6eb0577356a3e",
        "speedup_f32_bits": [1109609050, 1110074721, 1109469447]},
    8: {"beacons_tx": [901, 894, 894],
        "events_processed": [3360, 3360, 3360],
        "app_done_sha": "2593cfea7b845e7dd03abe2fad0b2f7d"
                        "eb8c1b413d231a4e3d4546e647cb0f76",
        "speedup_f32_bits": [1113580914, 1114055027, 1113652364]},
    16: {"beacons_tx": [977, 971, 980],
         "events_processed": [3456, 3456, 3456],
         "app_done_sha": "68377727efe15c681400b3106a67519f"
                         "bf59049e1b1fd5cff3ae8b37f4d29a21",
         "speedup_f32_bits": [1112794244, 1114050773, 1113350044]},
    256: {"beacons_tx": [612, 224, 204],
          "events_processed": [6432, 6432, 6432],
          "app_done_sha": "c795be0de366d0f95a7f749aea39eb73"
                          "1d6ccd06fbeb5e2f800c08e371a577d9",
          "speedup_f32_bits": [1108514464, 1109297876, 1109213258]},
}

FABRIC_KS = (16, 32)
FABRIC_SEEDS = (1, 2)
FABRIC_PAIR_PERIOD = 14_000.0
FABRIC_SIM_LENS = (1e6, 2.5e5, 1e5)
FABRIC_PARAMS = dict(m=256, n_childs=100, max_apps=64, queue_cap=8192)
FABRIC_KNOBS = {"dn_th": 4, "c_s": 8.0}
FABRIC_TOPOLOGIES = ("ideal", "shared_bus", "hier_tree", "mesh2d")
# The JAX reference's run of that spec on the CPU, made by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.experiment
#   import ExperimentSpec, WorkloadSpec; from repro.core.sim import
#   SimParams; from repro_torch.core import goldens as G; print({sl:
#   G.fabric_digest(ExperimentSpec(shapes=tuple(SimParams(k=k,
#   **G.FABRIC_PARAMS).shape for k in G.FABRIC_KS),
#   topologies=G.FABRIC_TOPOLOGIES, knobs=G.FABRIC_KNOBS, workloads=(
#   WorkloadSpec.make('interference', seeds=G.FABRIC_SEEDS,
#   pair_periods=(G.FABRIC_PAIR_PERIOD,)),), sim_len=sl, mode='seq')
#   .run()) for sl in G.FABRIC_SIM_LENS})"
FABRICS = {
    1000000.0: {
        16: {
            "ideal": {
                "events_processed": [6696, 6696],
                "beacons_tx": [1885, 1893],
                "beacons_rx": [0, 0],
                "evq_peak": [547, 537],
                "dropped": [0, 0],
                "mgmt_latency": [1872840.75, 2287543.0],
                "app_done_sha": "030361be819edb4eb6096d4949c15073"
                                "0eb4dc2b8fd2db9581530c482b388e90"},
            "shared_bus": {
                "events_processed": [34941, 34926],
                "beacons_tx": [1883, 1882],
                "beacons_rx": [28245, 28230],
                "evq_peak": [805, 901],
                "dropped": [0, 0],
                "mgmt_latency": [25366254.0, 26179352.0],
                "app_done_sha": "98cfc1a35504a430cf2c4c8363298bee"
                                "3fdbc26cef7e419824c7290446f7168a"},
            "hier_tree": {
                "events_processed": [35016, 35046],
                "beacons_tx": [1888, 1890],
                "beacons_rx": [28320, 28350],
                "evq_peak": [717, 790],
                "dropped": [0, 0],
                "mgmt_latency": [3363366.5, 3463099.0],
                "app_done_sha": "cdf5d452a58e71567d229bf86fb547d5"
                                "f21c81b83e742f17d2fadae14cd9870f"},
            "mesh2d": {
                "events_processed": [34896, 34971],
                "beacons_tx": [1880, 1885],
                "beacons_rx": [28200, 28275],
                "evq_peak": [683, 690],
                "dropped": [0, 0],
                "mgmt_latency": [669426.25, 664956.25],
                "app_done_sha": "5aaf4059fe43ad2b69b18ff9b603ae1f"
                                "f68721e486f7493c80ffcc64a35a8a67"},
        },
        32: {
            "ideal": {
                "events_processed": [7068, 7068],
                "beacons_tx": [2237, 2242],
                "beacons_rx": [0, 0],
                "evq_peak": [541, 526],
                "dropped": [0, 0],
                "mgmt_latency": [4931316.0, 5464424.0],
                "app_done_sha": "8e59a37f9b0c2bf29fbe23fd15c44305"
                                "abfe51b65e574af2a0d3a4b543f47eb7"},
            "shared_bus": {
                "events_processed": [69768, 70241],
                "beacons_tx": [2134, 2148],
                "beacons_rx": [63294, 63728],
                "evq_peak": [8192, 8192],
                "dropped": [3433, 3415],
                "mgmt_latency": [1370504448.0, 1413305088.0],
                "app_done_sha": "7c7fc2cc7c3427a569ddc0715b2575f6"
                                "989939d382073026f8f975dca2f9da73"},
            "hier_tree": {
                "events_processed": [75547, 76601],
                "beacons_tx": [2209, 2243],
                "beacons_rx": [68479, 69533],
                "evq_peak": [1179, 1239],
                "dropped": [0, 0],
                "mgmt_latency": [4687882.0, 4919742.5],
                "app_done_sha": "b15a83b595391b98642e4c3ab97fc207"
                                "80a16f893c5453ef457b62261ae94a63"},
            "mesh2d": {
                "events_processed": [76353, 76415],
                "beacons_tx": [2235, 2237],
                "beacons_rx": [69285, 69347],
                "evq_peak": [1197, 930],
                "dropped": [0, 0],
                "mgmt_latency": [1554946.875, 1548885.75],
                "app_done_sha": "08ca8790f541c963e11b22cdf370b9df"
                                "8694c918d021c3c9a4afc9e65e7e902c"},
        },
    },
    250000.0: {
        16: {
            "ideal": {
                "events_processed": [3456, 3456],
                "beacons_tx": [977, 971],
                "beacons_rx": [0, 0],
                "evq_peak": [508, 504],
                "dropped": [0, 0],
                "mgmt_latency": [1364735.25, 1123949.0],
                "app_done_sha": "374441ed8eab3b686bffa27c846224ea"
                                "16a71634b26b56106176765514b2a8dc"},
            "shared_bus": {
                "events_processed": [18231, 18216],
                "beacons_tx": [985, 984],
                "beacons_rx": [14775, 14760],
                "evq_peak": [794, 870],
                "dropped": [0, 0],
                "mgmt_latency": [14513621.0, 14889867.0],
                "app_done_sha": "88ba0ab76d8d285bf1618eb498082140"
                                "837db662ab26ea6ead90634da7841a8e"},
            "hier_tree": {
                "events_processed": [18141, 18171],
                "beacons_tx": [979, 981],
                "beacons_rx": [14685, 14715],
                "evq_peak": [685, 729],
                "dropped": [0, 0],
                "mgmt_latency": [1816900.5, 1872719.5],
                "app_done_sha": "b25eebcf5dabd5d3afb05c6b033a2a34"
                                "e040d9157cab5c3495d24d85e532c70d"},
            "mesh2d": {
                "events_processed": [18171, 18066],
                "beacons_tx": [981, 974],
                "beacons_rx": [14715, 14610],
                "evq_peak": [687, 637],
                "dropped": [0, 0],
                "mgmt_latency": [349452.5, 343338.0],
                "app_done_sha": "64354a283d985fc4c75f744b1f66a211"
                                "57aeaa4a1be0eba5ae32482222fb819f"},
        },
        32: {
            "ideal": {
                "events_processed": [3648, 3648],
                "beacons_tx": [1162, 1158],
                "beacons_rx": [0, 0],
                "evq_peak": [506, 496],
                "dropped": [0, 0],
                "mgmt_latency": [3603484.5, 3578900.0],
                "app_done_sha": "c244f9b0862a68e036a366f06bba7cd6"
                                "821f75aa20408e5eacdabfee11b37cc1"},
            "shared_bus": {
                "events_processed": [40104, 39856],
                "beacons_tx": [1176, 1168],
                "beacons_rx": [36456, 36208],
                "evq_peak": [6141, 5925],
                "dropped": [0, 0],
                "mgmt_latency": [434128288.0, 426117856.0],
                "app_done_sha": "252ca9855c055618d2cdfe11a7c563f0"
                                "cdb88b0905b9a273b489d10e67df8bef"},
            "hier_tree": {
                "events_processed": [39267, 39515],
                "beacons_tx": [1149, 1157],
                "beacons_rx": [35619, 35867],
                "evq_peak": [1148, 1239],
                "dropped": [0, 0],
                "mgmt_latency": [2551575.75, 2301543.0],
                "app_done_sha": "ac490608ff2f7d7d041bafa037eb26b8"
                                "9af0baf9487e2a4973bbdd1052099e44"},
            "mesh2d": {
                "events_processed": [39205, 39453],
                "beacons_tx": [1147, 1155],
                "beacons_rx": [35557, 35805],
                "evq_peak": [1160, 980],
                "dropped": [0, 0],
                "mgmt_latency": [798078.25, 802988.125],
                "app_done_sha": "fd2675e85b6b34b903771dee74371ae1"
                                "61ee03e2501267b1ca1b79726b4d972b"},
        },
    },
    100000.0: {
        16: {
            "ideal": {
                "events_processed": [1296, 1296],
                "beacons_tx": [364, 366],
                "beacons_rx": [0, 0],
                "evq_peak": [450, 368],
                "dropped": [0, 0],
                "mgmt_latency": [490616.0625, 439898.59375],
                "app_done_sha": "41a430cf180f7ee4979364af059bda66"
                                "7844d905b9dbf5e9b735628ffd7aa8f5"},
            "shared_bus": {
                "events_processed": [6861, 6771],
                "beacons_tx": [371, 365],
                "beacons_rx": [5565, 5475],
                "evq_peak": [753, 586],
                "dropped": [0, 0],
                "mgmt_latency": [5172311.0, 4675180.5],
                "app_done_sha": "d4a894cd7c09f3dcb0a9cbb54e185bc9"
                                "81339212fd0049c4990c5ce754969d8c"},
            "hier_tree": {
                "events_processed": [6831, 6756],
                "beacons_tx": [369, 364],
                "beacons_rx": [5535, 5460],
                "evq_peak": [584, 564],
                "dropped": [0, 0],
                "mgmt_latency": [760734.5, 765393.3125],
                "app_done_sha": "b5a43fe699c8c99cd1cbf498c851fb28"
                                "27dd37d082f0474cbb78ff0de1a3d638"},
            "mesh2d": {
                "events_processed": [6801, 6786],
                "beacons_tx": [367, 366],
                "beacons_rx": [5505, 5490],
                "evq_peak": [518, 473],
                "dropped": [0, 0],
                "mgmt_latency": [130075.734375, 132494.75],
                "app_done_sha": "aa12d8b16dc03d73bc2b6cac40f0f278"
                                "83eee38211ffd371efc14d73cddb5819"},
        },
        32: {
            "ideal": {
                "events_processed": [1368, 1368],
                "beacons_tx": [435, 433],
                "beacons_rx": [0, 0],
                "evq_peak": [416, 351],
                "dropped": [0, 0],
                "mgmt_latency": [1814720.5, 1460795.25],
                "app_done_sha": "89994a854503bd53d03debf803fd5c4e"
                                "1860a2aa043e1b3722fee43bd2c87359"},
            "shared_bus": {
                "events_processed": [14977, 14636],
                "beacons_tx": [439, 428],
                "beacons_rx": [13609, 13268],
                "evq_peak": [2478, 2205],
                "dropped": [0, 0],
                "mgmt_latency": [66121044.0, 64577916.0],
                "app_done_sha": "31e222415861494c5abf64389f621e80"
                                "ac7d8d8654d784aaff3b865ceb5d86c9"},
            "hier_tree": {
                "events_processed": [14729, 14791],
                "beacons_tx": [431, 433],
                "beacons_rx": [13361, 13423],
                "evq_peak": [1102, 1126],
                "dropped": [0, 0],
                "mgmt_latency": [980916.75, 1064409.5],
                "app_done_sha": "ed9afbcac03c73d68549a80acf597260"
                                "d262faa227a0e23fb9cc7512751bdc1d"},
            "mesh2d": {
                "events_processed": [14791, 14822],
                "beacons_tx": [433, 434],
                "beacons_rx": [13423, 13454],
                "evq_peak": [811, 754],
                "dropped": [0, 0],
                "mgmt_latency": [300633.5625, 299891.625],
                "app_done_sha": "8fde19351915ce1898296e6a7cc51a58"
                                "1ebd1794df7c3430c18f0f48d5c34ac8"},
        },
    },
}

CUT_KS = (1, 256)
CUT_QUEUES = {1: dict(queue_cap=8192, queue_impl="linear", batch_pop=1),
              256: dict(queue_cap=32768, queue_impl="tree", batch_pop=64)}
CUT_TOPOLOGIES = {1: ("ideal",), 256: ("hier_tree", "mesh2d")}
CUT_SIM_LENS = {1: (2.5e5,), 256: (2.5e5, 1e5)}
# The JAX reference's run of those points on the CPU (~25 s), made by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.experiment
#   import ExperimentSpec, WorkloadSpec; from repro.core.sim import
#   SimParams; from repro_torch.core import goldens as G; print({sl: {k:
#   G.cut_digest(ExperimentSpec(shapes=(SimParams(k=k, **G.cut_params(k))
#   .shape,), topologies=G.CUT_TOPOLOGIES[k], knobs=G.FABRIC_KNOBS,
#   workloads=(WorkloadSpec.make('interference', seeds=G.FABRIC_SEEDS,
#   pair_periods=(G.FABRIC_PAIR_PERIOD,)),), sim_len=sl, mode='seq')
#   .run(), k) for k in G.CUT_KS if sl in G.CUT_SIM_LENS[k]} for sl in
#   (2.5e5, 1e5)})"
CUTS = {
    250000.0: {
        1: {
            "ideal": {
                "events_processed": [3264, 3264],
                "beacons_tx": [0, 0],
                "beacons_rx": [0, 0],
                "evq_peak": [556, 469],
                "dropped": [0, 0],
                "mgmt_latency": [17442106.0, 13008173.0],
                "app_done_sha": "f09689d9064d94c95c7a0ab36f7c50bc"
                                "013cd568a9c129c673ac144e353bd42f"},
        },
        256: {
            "hier_tree": {
                "events_processed": [162492, 63552],
                "beacons_tx": [612, 224],
                "beacons_rx": [156060, 57120],
                "evq_peak": [15338, 7154],
                "dropped": [0, 0],
                "mgmt_latency": [54156696.0, 29526332.0],
                "app_done_sha": "4b437c71047b9f5e384d104bc7228502"
                                "cc826f42ffbcafe1d67f532b42c4df64"},
            "mesh2d": {
                "events_processed": [162492, 64062],
                "beacons_tx": [612, 226],
                "beacons_rx": [156060, 57630],
                "evq_peak": [3045, 2557],
                "dropped": [0, 0],
                "mgmt_latency": [6653400.0, 3571250.5],
                "app_done_sha": "e0a446bdca94399e7fcf388587a50305"
                                "72518abdd14aa35f7f7d7c3e4126abd0"},
        },
    },
    100000.0: {
        256: {
            "hier_tree": {
                "events_processed": [50862, 5982],
                "beacons_tx": [190, 14],
                "beacons_rx": [48450, 3570],
                "evq_peak": [12903, 2184],
                "dropped": [0, 0],
                "mgmt_latency": [16850412.0, 3142464.75],
                "app_done_sha": "11cc8befc7905c7cc0273f9ed0441da9"
                                "251360ce66c53f993918554274670140"},
            "mesh2d": {
                "events_processed": [50862, 5982],
                "beacons_tx": [190, 14],
                "beacons_rx": [48450, 3570],
                "evq_peak": [2454, 1992],
                "dropped": [0, 0],
                "mgmt_latency": [2239336.5, 683251.75],
                "app_done_sha": "b1f26c33726841c8867d14a5cadf31fe"
                                "892c6bc56efb514ce8033dad44110199"},
        },
    },
}

FAULT_K = 16
FAULT_SIM_LEN = 1e5
# the detector tier's knobs (fault_frontier's): a raised c_b makes the
# messages to dead managers a first-order cost
DETECTOR_KNOBS = dict(FABRIC_KNOBS, T_b=2000.0, susp_mult=8.0,
                      retry_after=250.0, c_b=80.0)
# The JAX reference's run of fault_specs() on the CPU, made by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.experiment
#   import ExperimentSpec, WorkloadSpec; from repro.core.faults import
#   FaultSpec; from repro.core.sim import SimParams; from repro_torch.core
#   import goldens as G; print(G.fault_digests([s.run() for s in
#   G.fault_specs(ExperimentSpec, WorkloadSpec, SimParams, FaultSpec)]))"
FAULTS = {
    "hier_tree/min_search/threshold/none": {
        "events_processed": [6831, 6756],
        "beacons_tx": [369, 364],
        "beacons_rx": [5535, 5460],
        "msgs_lost": [0, 0],
        "reroutes": [0, 0],
        "retries_tx": [0, 0],
        "susp_false_pos": [2022, 2126],
        "downtime": [0.0, 0.0],
        "susp_onsets": [2022, 2126],
        "app_done_sha": "b5a43fe699c8c99cd1cbf498c851fb28"
                        "27dd37d082f0474cbb78ff0de1a3d638"},
    "hier_tree/min_search/threshold/poisson_links": {
        "events_processed": [6646, 6648],
        "beacons_tx": [367, 365],
        "beacons_rx": [5224, 5226],
        "msgs_lost": [281, 249],
        "reroutes": [40, 46],
        "retries_tx": [0, 0],
        "susp_false_pos": [2191, 2105],
        "downtime": [1080000.0, 1080000.0],
        "susp_onsets": [2214, 2132],
        "app_done_sha": "24bb9781c472f6e745e07fc20c01bb82"
                        "76c709be42a892ad0d601ec68ff04caf"},
    "hier_tree/min_search/threshold/partition": {
        "events_processed": [6104, 5934],
        "beacons_tx": [368, 362],
        "beacons_rx": [4552, 4382],
        "msgs_lost": [968, 1048],
        "reroutes": [191, 188],
        "retries_tx": [0, 0],
        "susp_false_pos": [1707, 1577],
        "downtime": [3840000.0, 3840000.0],
        "susp_onsets": [1771, 1633],
        "app_done_sha": "2bf99d9f6cf5d7189c7e946fd9a81984"
                        "dad5a531c0ca5f79bcd71f59ce729496"},
    "hier_tree/min_search/threshold/gmn_churn": {
        "events_processed": [6373, 6367],
        "beacons_tx": [358, 354],
        "beacons_rx": [5072, 5066],
        "msgs_lost": [298, 244],
        "reroutes": [43, 12],
        "retries_tx": [0, 0],
        "susp_false_pos": [1905, 1990],
        "downtime": [60000.0, 60000.0],
        "susp_onsets": [1905, 2019],
        "app_done_sha": "aa57d5a6ecc6b42b6860b1d73e55a0de"
                        "07e5937bab67b754dcb05c67ec3a18ba"},
    "mesh2d/min_search/threshold/partition": {
        "events_processed": [6018, 5880],
        "beacons_tx": [366, 360],
        "beacons_rx": [4466, 4328],
        "msgs_lost": [1024, 1072],
        "reroutes": [204, 199],
        "retries_tx": [0, 0],
        "susp_false_pos": [1646, 1644],
        "downtime": [3840000.0, 3840000.0],
        "susp_onsets": [1718, 1716],
        "app_done_sha": "e6a3c3cb3b2ca9d573e6ec1576a35f5f"
                        "a485c3fada99899c65a35864016b98f5"},
    "hier_tree/min_search/periodic/gmn_outage": {
        "events_processed": [5302, 5332],
        "beacons_tx": [266, 268],
        "beacons_rx": [3646, 3700],
        "msgs_lost": [884, 796],
        "reroutes": [351, 70],
        "retries_tx": [540, 476],
        "susp_false_pos": [164, 328],
        "downtime": [400000.0, 400000.0],
        "susp_onsets": [228, 400],
        "app_done_sha": "513d3ecb349dd842d56434ff0676ad06"
                        "182cc3c407f7ad9a8bb580c00353b8f4"},
    "hier_tree/avoid_suspected/periodic/gmn_outage": {
        "events_processed": [4612, 5257],
        "beacons_tx": [220, 263],
        "beacons_rx": [2996, 3649],
        "msgs_lost": [700, 756],
        "reroutes": [293, 58],
        "retries_tx": [396, 460],
        "susp_false_pos": [183, 268],
        "downtime": [400000.0, 400000.0],
        "susp_onsets": [247, 340],
        "app_done_sha": "a922d4dc20037aa5a3eb76ea16940284"
                        "1b86803fa98bf6d76a8361890f8fd0bf"},
    "hier_tree/suspect_weighted/periodic/gmn_outage": {
        "events_processed": [4672, 4807],
        "beacons_tx": [224, 233],
        "beacons_rx": [3056, 3247],
        "msgs_lost": [708, 708],
        "reroutes": [290, 84],
        "retries_tx": [404, 460],
        "susp_false_pos": [185, 199],
        "downtime": [400000.0, 400000.0],
        "susp_onsets": [249, 279],
        "app_done_sha": "89cd42e608561db5d1590cfd20e90d5d"
                        "9e50f0210e1662703ef1df14f920b835"},
    "hier_tree/avoid_suspected/heartbeat/gmn_outage": {
        "events_processed": [6431, 6506],
        "beacons_tx": [289, 294],
        "beacons_rx": [4007, 4122],
        "msgs_lost": [748, 724],
        "reroutes": [274, 54],
        "retries_tx": [420, 436],
        "susp_false_pos": [77, 77],
        "downtime": [400000.0, 400000.0],
        "susp_onsets": [141, 141],
        "app_done_sha": "184f3ab08f09663ca0dab33a9ec8fcf7"
                        "f3ea95d4937688436e348fd08551468c"},
}


def fault_specs(ExperimentSpec, WorkloadSpec, SimParams, FaultSpec,
                sim_len: float = FAULT_SIM_LEN, mode: str = "seq"):
    """The fault groups of the card's phase, as ExperimentSpecs of the
    package whose classes are passed (the reference's or the port's):
    the tier of FABRICS at k=16, 2 lanes a group, with the fault times
    scaled to ``sim_len`` as ``benchmarks/fault_frontier.py`` scales
    them (partition 0.3-0.6, outage 0.3-0.8; the Poisson and churn rates
    of its ``tiny`` grid).

    - main tier, ``min_search``/``threshold``: ``hier_tree`` under no
      fault, Poisson link failures, a partition and GMN churn, and
      ``mesh2d`` under the partition;
    - detector tier on ``hier_tree`` with DETECTOR_KNOBS under a
      power-domain outage: ``min_search``, ``avoid_suspected`` and
      ``suspect_weighted`` under ``periodic`` beacons, and
      ``avoid_suspected`` under ``heartbeat``."""
    base = SimParams(k=FAULT_K, **FABRIC_PARAMS)
    wl = (WorkloadSpec.make("interference", seeds=FABRIC_SEEDS,
                            pair_periods=(FABRIC_PAIR_PERIOD,)),)
    part = FaultSpec.partition(t_down=0.3 * sim_len, t_heal=0.6 * sim_len)
    main = (FaultSpec.none(),
            FaultSpec.poisson_links(rate=4e-4, repair=2e4, seed=0),
            part, FaultSpec.gmn_churn(rate=4e-5, repair=3e4, seed=0))
    outage = FaultSpec.gmn_outage(t_down=0.3 * sim_len,
                                  t_heal=0.8 * sim_len)
    kw = dict(base=base, workloads=wl, sim_len=sim_len, mode=mode)
    return [
        ExperimentSpec(topologies=("hier_tree",), knobs=FABRIC_KNOBS,
                       faults=main, **kw),
        ExperimentSpec(topologies=("mesh2d",), knobs=FABRIC_KNOBS,
                       faults=(part,), **kw),
        ExperimentSpec(topologies=("hier_tree",), knobs=DETECTOR_KNOBS,
                       policies=(("min_search", "periodic"),
                                 ("avoid_suspected", "periodic"),
                                 ("suspect_weighted", "periodic"),
                                 ("avoid_suspected", "heartbeat")),
                       faults=(outage,), **kw)]


def fault_key(coords: dict) -> str:
    """A fault group's key in FAULTS: fabric/mapping/beacon/fault."""
    return "/".join(str(coords[c]) for c in
                    ("topology", "mapping", "beacon", "fault"))


def fault_state_digest(st) -> dict:
    """The per-lane fault counters and the ``app_done`` sha256 of a
    fault-aware (B, S, ...) state (numpy leaves), keyed as a FAULTS
    entry."""
    row = {key: np.asarray(st[key]).ravel().tolist()
           for key in ("events_processed", "beacons_tx", "beacons_rx",
                       "msgs_lost", "reroutes", "retries_tx",
                       "susp_false_pos")}
    row["downtime"] = [float(x) for x in np.asarray(
        st["downtime"], np.float32).ravel()]
    ons = np.asarray(st["susp_onsets"])
    row["susp_onsets"] = ons.reshape(ons.shape[:-2] + (-1,)).sum(-1) \
        .ravel().tolist()
    row["app_done_sha"] = sha256_f32(st["app_done"])
    return row


def fault_digests(frames) -> dict:
    """The digests of the fault_specs() ResultFrames (the port's or the
    reference's), keyed as FAULTS."""
    return {fault_key(dict(g.combo.coords(), fault=g.fault_label)):
            fault_state_digest(g.state) for fr in frames for g in fr.groups}


# phase trace's TraceSpec (trace_report's TRACE) and its three runs:
# the paper point, the tier's k=16 hier_tree group (linear queue), and
# a partition on the tree queue with batch_pop 64 and a small ring
TRACE_FIELDS = dict(ring_cap=16384, sample_every=64, n_samples=512,
                    hist_bins=64, bins_per_octave=4)
TRACE_SIM_LENS = {"paper": 1e6, "hier_tree": 1e5, "partition": 2e4}
TRACE_SMALL_RING = 1024
# The JAX reference's runs of trace_runs() on the CPU (~2 min), made by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import jax; from repro.core
#   import sim, workloads; from repro.core.experiment import
#   ExperimentSpec, WorkloadSpec; from repro.core.faults import FaultSpec;
#   from repro.core.trace import TraceSpec; from repro_torch.core import
#   goldens as G; print({name: G.trace_digest(jax.device_get(st)) for
#   name, st in G.trace_runs(sim, workloads, ExperimentSpec, WorkloadSpec,
#   FaultSpec, TraceSpec).items()})"
TRACE = {
    "paper": {
        "tr_n": [13824],
        "trace_dropped": [0],
        "tl_n": [216],
        "th_mgmt": [[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 59148, 1208, 1387,
                   1649, 5525, 1205, 2740, 943, 1726, 7087, 2011, 1412, 1589,
                   990, 972, 917, 672, 568, 812, 648, 548, 446, 560, 1065,
                   209, 135, 158, 126, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
        "th_resp": [[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 0,
                   4, 105, 6, 7, 2]],
        "ring_sha": "29dcb7ad39d8474417ef90b64c06723c"
                    "903dc54daa694acc7c553830680765c1",
        "tl_t_sha": "693a87d2e32b78608be31b1bdbc890cf"
                    "5117684a5f449d71de34ca979368dd3f",
        "tl_busy_sha": "93bc53505d4fe55d63ef5bd22b5bd2b7"
                       "4eaa631c53cb40b0a41be24c0f214315",
        "tl_load_sha": "d9018bab42554e4416da102d8d5e33f8"
                       "0a3800934b771f8d36e4cced86071a5a",
        "tl_qdepth_sha": "2fdaa61c5661c772f7410fb961c672f0"
                         "46b6b33a4fb4d72b7eb9f96be315fe2a",
        "ring_lat_sum": [3619651.0],
        "tl_stale_sum": [[655138.6525268555, 655138.6525268555,
                        655138.6525268555, 655138.6525268555,
                        655138.6525268555, 655138.6525268555,
                        655138.6525268555, 655138.6525268555,
                        655138.6525268555, 655138.6525268555,
                        655138.6525268555, 655138.6525268555,
                        655138.6525268555, 655138.6525268555,
                        655138.6525268555, 655138.6525268555]],
    },
    "hier_tree": {
        "tr_n": [6831, 6756],
        "trace_dropped": [0, 0],
        "tl_n": [106, 105],
        "th_mgmt": [[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 721, 16, 9, 19,
                   3898, 96, 811, 42, 297, 237, 706, 153, 190, 170, 83, 94,
                   208, 148, 85, 156, 156, 138, 195, 204, 129, 91, 50, 23, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0], [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 572, 7, 21,
                   16, 3347, 31, 1048, 51, 487, 218, 694, 114, 261, 184, 90,
                   92, 251, 190, 167, 191, 224, 202, 230, 183, 80, 28, 29, 25,
                   2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0]],
        "th_resp": [[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 1,
                   0, 4, 2, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 4, 2, 0, 6, 0, 0, 0]],
        "ring_sha": "97a1e39aade94fa934d37a93d0314024"
                    "bae4ba52fdf1c7d7b288dca0b6371a04",
        "tl_t_sha": "c792cdf061bbdaf67077096817429e9d"
                    "c37d823c5a63dc4e8a07ebfe4c46d29d",
        "tl_busy_sha": "130663bf5956362a0275641181a492fe"
                       "af12200891ddbc2a0dfb5d414aecfbfa",
        "tl_load_sha": "bd0caa74f04c635584fc64a900099c68"
                       "e5fab0a6355c46ee11b40d44ec84ff3c",
        "tl_qdepth_sha": "914775d9bbc9b4866e1b0d422d3f4ec3"
                         "80c939d5b1fb614e5b04d1d167fd918a",
        "ring_lat_sum": [760734.5, 765393.3125],
        "tl_stale_sum": [[483034.12438964844, 478976.75244140625,
                        480171.37890625, 484522.47998046875, 486073.662109375,
                        489889.3477783203, 490251.4483642578,
                        492016.6141357422, 495212.5974121094,
                        495835.8981933594, 498271.19860839844,
                        505980.65368652344, 495949.28649902344,
                        503708.36560058594, 505335.44104003906,
                        501128.69384765625], [471966.2473144531,
                        475241.51123046875, 474871.4309082031,
                        480423.3709716797, 474056.36279296875,
                        474985.40576171875, 473341.87109375,
                        483397.2166748047, 476872.8112792969,
                        482449.37438964844, 485009.9755859375,
                        487137.5925292969, 488831.01037597656,
                        487913.0734863281, 489683.04235839844,
                        494477.2824707031]],
    },
    "partition": {
        "tr_n": [1256, 1312],
        "trace_dropped": [232, 288],
        "tl_n": [19, 20],
        "th_mgmt": [[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 81, 1, 0, 1, 396,
                   1, 185, 2, 89, 35, 104, 23, 55, 40, 24, 30, 44, 26, 48, 46,
                   51, 41, 34, 25, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 50, 0, 7, 1, 323, 4, 228, 5, 105, 56,
                   141, 64, 35, 37, 12, 47, 61, 41, 40, 41, 34, 35, 47, 24, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0]],
        "th_resp": [[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0,
                   0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   0, 0, 0, 2, 0, 0, 0, 0, 0, 0]],
        "ring_sha": "8e01fcc59056a3a7e5c17f4ae8b10734"
                    "5fad459dfe0728f0878c8666de7e0143",
        "tl_t_sha": "efc6405179afcf81ab42ae49e4e66a9c"
                    "d8c8b96f2d01d367089eb0545b4e7d38",
        "tl_busy_sha": "624a911c0ea8d616eff65ffdce0b1bd4"
                       "6bcb52c204c168119dc56bd1096ce08a",
        "tl_load_sha": "901f0a8cc7f6c8c87f528c25fe3f0d9f"
                       "a250b01561c9cdfe1250caa9c0559b67",
        "tl_qdepth_sha": "c6c3eabf39c9bfc9dfb40f0ac988c5be"
                         "955b4d8a77a02eaa2b5408776742ecd1",
        "ring_lat_sum": [104826.921875, 103391.765625],
        "tl_stale_sum": [[147724.9755859375, 148740.1357421875,
                        148800.6357421875, 149824.5185546875,
                        149019.7119140625, 149106.91064453125,
                        149155.41064453125, 148247.396484375,
                        164461.42919921875, 163559.61474609375,
                        166114.7587890625, 166114.7587890625,
                        166110.044921875, 165944.1904296875,
                        164980.5986328125, 164969.0986328125],
                        [126199.36828613281, 126219.19348144531,
                        126039.36828613281, 126020.86828613281,
                        125049.86535644531, 125061.86535644531,
                        125098.36535644531, 125155.86535644531,
                        125246.28820800781, 126078.36767578125,
                        125114.86511230469, 125086.94262695312,
                        125040.06799316406, 124026.06469726562,
                        124009.91027832031, 126199.36828613281]],
    },
}


def trace_specs(ExperimentSpec, WorkloadSpec, SimParams, FaultSpec,
                TraceSpec, mode: str = "seq") -> dict:
    """Phase trace's ``hier_tree`` and ``partition`` runs as
    ExperimentSpecs of the package whose classes are passed: the tier
    of FABRICS at k=16 on ``hier_tree``, seeds 1 and 2 (one group of 2
    lanes each) — on the linear queue at 1e5, and on the tree queue
    with batch_pop 64 under a partition (0.3-0.6 of the horizon) at 2e4
    with a ring of TRACE_SMALL_RING rows."""
    wl = (WorkloadSpec.make("interference", seeds=FABRIC_SEEDS,
                            pair_periods=(FABRIC_PAIR_PERIOD,)),)
    kw = dict(topologies=("hier_tree",), knobs=FABRIC_KNOBS, workloads=wl,
              mode=mode)
    sl = TRACE_SIM_LENS["partition"]
    return {
        "hier_tree": ExperimentSpec(
            shapes=(SimParams(k=16, **FABRIC_PARAMS).shape,),
            trace=TraceSpec(**TRACE_FIELDS),
            sim_len=TRACE_SIM_LENS["hier_tree"], **kw),
        "partition": ExperimentSpec(
            shapes=(SimParams(k=16, queue_impl="tree", batch_pop=64,
                              **FABRIC_PARAMS).shape,),
            faults=(FaultSpec.partition(t_down=0.3 * sl, t_heal=0.6 * sl),),
            trace=TraceSpec(**dict(TRACE_FIELDS,
                                   ring_cap=TRACE_SMALL_RING)),
            sim_len=sl, **kw)}


def trace_runs(sim, workloads, ExperimentSpec, WorkloadSpec, FaultSpec,
               TraceSpec, mode: str = "seq", **run_kw) -> dict:
    """The final states of phase trace's three runs through the package
    whose modules and classes are passed (the reference's or the
    port's; ``run_kw`` goes to each run, e.g. ``device``): ``paper``
    (the paper point through ``sim.run``, unbatched), and the
    :func:`trace_specs` groups ((1, 2) lanes)."""
    p = sim.SimParams()
    sl = TRACE_SIM_LENS["paper"]
    out = {"paper": sim.run(p, *workloads.interference(
        p, sim_len=sl, seed=PAPER_SEED), sl,
        trace=TraceSpec(**TRACE_FIELDS), **run_kw)}
    for name, spec in trace_specs(ExperimentSpec, WorkloadSpec,
                                  sim.SimParams, FaultSpec, TraceSpec,
                                  mode).items():
        out[name] = spec.run(**run_kw).state(k=16)
    return out


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trace_digest(st) -> dict:
    """The trace leaves of a state (any leading axes), keyed as a TRACE
    entry: per lane the counts and histograms (integers), sha256s of the
    leaves held bitwise (the ring's [t, type, slot, a0, a1] columns and
    the timelines but ``tl_stale``), the float64 sum of the ring's
    ``lat`` column and, per GMN, the float64 sum of ``tl_stale``."""
    st = {key: _host(v) for key, v in st.items()}
    lead = st["tr_n"].shape
    n = int(np.prod(lead))

    def lanes(key):
        return st[key].reshape((n,) + st[key].shape[len(lead):])
    row = {key: lanes(key).astype(np.int64).tolist()
           for key in ("tr_n", "trace_dropped", "tl_n", "th_mgmt",
                       "th_resp")}
    row["ring_sha"] = sha256_f32(lanes("tr_ring")[..., :5])
    for key in ("tl_t", "tl_busy", "tl_load", "tl_qdepth"):
        row[f"{key}_sha"] = hashlib.sha256(lanes(key).tobytes()).hexdigest()
    row["ring_lat_sum"] = lanes("tr_ring")[..., 5].astype(np.float64) \
        .sum(-1).tolist()
    row["tl_stale_sum"] = lanes("tl_stale").astype(np.float64) \
        .sum(-2).tolist()
    return row


def trace_mismatches(got: dict, want: dict) -> list:
    """The keys of a trace_digest ``got`` that differ from ``want``:
    exact but the ring's lat sum (rtol 1e-5: differences of the f32
    running mgmt_latency) and the tl_stale sums (rtol 1e-6: f32 means
    over k)."""
    tol = {"ring_lat_sum": 1e-5, "tl_stale_sum": 1e-6}
    return [(key, got.get(key), w) for key, w in want.items()
            if not (np.allclose(got[key], w, rtol=tol[key], atol=0)
                    if key in tol else got.get(key) == w)]


SERVE = {"finished": 64, "waves": 1, "imbalance": 1.0047190851197014,
         "beacons_tx": 20}

PAPER_SEED = 1
PAPER_POINT = {
    4e6: {"events_processed": 55080, "beacons_tx": 15436, "evq_peak": 988,
          "app_done_sha": "93c9930d7e9445d631d7619fe0168c3d"
                          "c1b86209f7771ad324c09815da6f5e86",
          "mean_response": 32855.85490196078},
    1e6: {"events_processed": 13824, "beacons_tx": 3896, "evq_peak": 613,
          "app_done_sha": "795a787605b3ebe23d5258f8fab5273d"
                          "3cbc11131e7b284fc8ac06af1e07fa2d",
          "mean_response": 32177.28125},
}


def sha256_f32(x) -> str:
    """sha256 of an array's float32 bytes (a tensor is read to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return hashlib.sha256(np.asarray(x, np.float32).tobytes()).hexdigest()


def golden_grid(device=None) -> dict:
    """The golden grid and single-app anchor through the port on
    ``device``: per-config runs, stacked (dn_th, seed).  ``events`` is
    the total processed over all nine runs."""
    beacons, done, events = [], [], 0
    for th in GRID_DN_TH:
        p = SimParams(dn_th=th, **GRID_PARAMS)
        row_b, row_d = [], []
        for s in GRID_SEEDS:
            wl = W.interference(p, sim_len=GRID_SIM_LEN, seed=s)
            st = run(p, *wl, GRID_SIM_LEN, device=device)
            row_b.append(int(st["beacons_tx"]))
            events += int(st["events_processed"])
            row_d.append(st["app_done"].cpu().numpy())
        beacons.append(row_b)
        done.append(row_d)
    p = SimParams(**GRID_PARAMS)
    st1 = run(p, *W.independent_tasks(p, n_apps=1), 1e7, device=device)
    return {"events": events + int(st1["events_processed"]),
            "beacons_tx": beacons,
            "app_done_sha": sha256_f32(np.stack([np.stack(r) for r in done])),
            "single_app_done": float(st1["app_done"][0]),
            "single_app_beacons": int(st1["beacons_tx"])}


def paper_point_digest(state) -> dict:
    """The digests of a paper-point final state, keyed as PAPER_POINT."""
    return {"events_processed": int(state["events_processed"]),
            "beacons_tx": int(state["beacons_tx"]),
            "evq_peak": int(state["evq_peak"]),
            "app_done_sha": sha256_f32(state["app_done"]),
            "mean_response": float(M.mean_response(state))}


def table5_digest(frame) -> dict:
    """The digests of a Table 5 ResultFrame (the port's or the
    reference's: both give numpy state leaves), keyed as TABLE5."""
    out = {}
    for k in TABLE5_KS:
        st = frame.state(k=k)
        speedup = np.asarray(frame.speedup(k=k), np.float32)
        out[k] = {"beacons_tx": np.asarray(st["beacons_tx"]).ravel().tolist(),
                  "events_processed":
                      np.asarray(st["events_processed"]).ravel().tolist(),
                  "app_done_sha": sha256_f32(st["app_done"]),
                  "speedup_f32_bits": speedup.view(np.uint32).tolist()}
    return out


def state_digest(st) -> dict:
    """The per-lane counters and the ``app_done`` sha256 of a (B, S, ...)
    state (numpy leaves), keyed as a FABRICS or CUTS entry."""
    row = {key: np.asarray(st[key]).ravel().tolist()
           for key in ("events_processed", "beacons_tx", "beacons_rx",
                       "evq_peak", "dropped")}
    row["mgmt_latency"] = [float(x) for x in np.asarray(
        st["mgmt_latency"], np.float32).ravel()]
    row["app_done_sha"] = sha256_f32(st["app_done"])
    return row


def fabric_digest(frame) -> dict:
    """The digests of a fabric ResultFrame (the port's or the
    reference's), keyed as one sim_len's entry of FABRICS."""
    return {k: {topo: state_digest(frame.state(k=k, topology=topo))
                for topo in FABRIC_TOPOLOGIES} for k in FABRIC_KS}


def cut_params(k: int) -> dict:
    """The SimParams fields (but k) of the cut point at ``k``."""
    return dict(FABRIC_PARAMS, **CUT_QUEUES[k])


def cut_digest(frame, k: int) -> dict:
    """The digests of a cut point's ResultFrame, keyed as one (sim_len,
    k) entry of CUTS."""
    return {topo: state_digest(frame.state(k=k, topology=topo))
            for topo in CUT_TOPOLOGIES[k]}


def paper_point(sim_len: float = 4e6, device=None) -> dict:
    """Run the paper point through the port on ``device``."""
    p = SimParams()
    wl = W.interference(p, sim_len=sim_len, seed=PAPER_SEED)
    return paper_point_digest(run(p, *wl, sim_len, device=device))
