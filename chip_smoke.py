#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports no JAX
and nothing of the JAX package.  Phases, each printing one JSON line;
any failure ends the run with a non-zero exit:

1. device   the card's ``nvidia-smi`` name and power limit (also printed
            raw on a line of their own), torch and CUDA versions;
2. build    compiles every kernel source of the port with ``nvcc``, one
            process per source, all at once: seconds per library,
            ptxas's registers, spill and stack bytes per kernel, the
            count of ``HGMMA`` (tensor-core ``wgmma``) instructions in
            K2's library, which must not be 0, and in each bf16 instance
            of the backward's ``bwd_dkdv`` and ``bwd_dq`` (``tc::``, one
            per head dim), none of which may hold 0, with their
            registers and spills, and for each instance of
            K1's warp kernel its ``REDUX`` and ``BAR`` instructions:
            at least one ``REDUX``, no ``BAR``, no spills, no stack;
            and for each instance of the scan's backward
            ``ssm_scan_bwd`` its ``MUFU.EX2`` count (at most one a
            recomputed state-step: none in the walk back) and no
            spills;
3. k1       the mapper's two kernels (warp and block) against its plain
            torch version on the card, at the ``scheduler_overhead``
            shapes (m=256, k in {1, 8, 16, 32, 256}, T=100), random
            floats and the all-zero tie, NaN and infinite loads and
            costs, -0.0, odd shapes and one shape (64 x 64) above the
            warp kernel's capacity that only the block kernel takes;
            at the m=256 shapes each kernel's device time per launch
            (``torch.profiler``), its time per Python call (CUDA
            events), the plain version's and the empty launch's;
4. k2       flash attention against its plain version, on the JAX
            tests' cases in f32 and bf16, at the reduced Jamba's shape
            (head dim 16), at every head dim with lengths that are not
            multiples of the bf16 kernel's 128-row tiles (Sq < Skv, a
            window), at the last five families' shapes (whisper_medium's
            cross attention, Sq=2048 > Skv=1500 with no mask, and its
            1500 x 1500 encoder; glm4_9b's 32 q heads over 2; minicpm_2b's
            36 heads) and at Jamba's prefill shape (B=2, S=4096, Hq=32,
            Hkv=8, D=128, causal); kernel, plain, bound and
            ``scaled_dot_product_attention`` times there; a bf16 input
            that is not 16-byte aligned must raise;
5. k3       the selective scan against its plain version, on the JAX
            tests' cases, on lengths and widths that are not multiples
            of the kernel's 64-step runs and channel blocks (and rows
            that are not whole 16-byte chunks), and at Jamba's shape
            (B=2, S=4096, Di=8192, N=16, f32 A); its training variant
            (``with_states``) must give K3's y bit for bit and the
            plain version's run-start states (within 1e-4 of their
            largest magnitude, f32 in both dtypes) on every case; the
            kernel's and the training variant's times (in turns), plain
            times and bounds (the variant's with its states' bytes);
6. golden   the frozen golden grid and single-app anchor (nine runs of
            ``sim.run``: the paper's program, so nine launches of the
            event-loop kernel ``tlm_loop``);
7. paper    the paper point (m=256, k=16, n_childs=100, queue_cap=2048,
            interference seed 1) at sim_len 1e6 (13,824 events), one
            ``tlm_loop`` launch, timed, against the frozen digests;
8. mapper   ``mapping.map_batch``/``map_one`` on a cuda ``MapperState``
            at m=256, k=16, T=100, against the plain version;
9. profile  the paper point at sim_len 2.5e5 (cut from 1e6 in PR 25
            for the script's time; the JAX reference's digest) through
            the host loop (``sim.simulate_host``, the kernel's plain
            version), timed, then run again under ``torch.profiler``:
            kernels per event and device kernel time against the timed
            run's wall (the host loop's device busy share);
10. syncs   the profiled run, under torch's sync debug mode as well,
            which warns at every call that waits for the card: all but a
            few set-up syncs must come from the loop's one packed read
            per event; held against the static guard
            (``analysis.lint.lint_paths`` over the port's core and
            serving files, which must find nothing): the packed read's
            line carries the lint's ``allow(host-sync)`` pragma and
            every other line that synced lies outside the loop path the
            lint computes; then one covered ``lanes.simulate_lanes``
            call (fig3a's k=16 group at 5e4, 12 lanes) under the same
            mode: one ``tlm_loop`` launch, a few set-up syncs before it
            and only the status read after it;
11. sweep   the design-space engine, every sweep in ``"vmap"`` mode
            (``lanes.simulate_lanes``: each group here the paper's
            program, one ``tlm_loop`` launch; ``"seq"`` one a lane;
            the kernels and syncs a step counted on the host loop,
            ``lanes.simulate_lanes_host``): the golden
            grid and the fig3b spot grid (m=64, k=16, 6 lanes, sim_len
            2.5e5 since phase 28, 1e6 before) through ``sweep`` against
            their frozen digests; Table 5
            at the paper's widths (m=256, k in {1, 8, 16, 256}, seeds
            1-3) cut to sim_len 1e5 through ``ExperimentSpec.run()``
            against the JAX reference's frozen digests, with its ordering
            claim and k16/k1 ratio (reported, not gated); fig3a's k=16
            group (12 lanes, sim_len 5e4 since phase 28, 1e5 before)
            timed in ``"vmap"`` mode and two of its lanes in ``"seq"``
            mode (equal leaves), and at sim_len 5e4 its device kernels
            and syncs per step (the
            ``scheduler_overhead`` runner moved to phase 28);
12. fabrics  ``shared_bus`` and ``hier_tree`` at k=16 and ``shared_bus``
            at k=32 through the lane loop on the linear queue at the
            paper tier of ``topology_frontier`` (m=256, n_childs=100,
            max_apps=64, queue_cap=8192, c_s=8, dn_th=4, interference
            seeds 1-2 at pair_period 14,000: 3 groups of 2 lanes;
            ``mesh2d``, and ``hier_tree`` at k=32, run in phase 13 on the
            tree queue): ``hier_tree`` at k=16 at sim_len 5e4 (the
            probe, and the baseline of phases 13-15; 1e5 until phase
            29 came), then the rest
            and the seq runs at 1e6 — or 5e4, said in the line, when the
            probe's rate would put 1e6 over the phase's 150 s — against
            the JAX
            reference's frozen digests (``goldens.FABRICS``), with
            ``beacons_rx == (k-1) * beacons_tx`` and an empty ``bcn_t``
            on every lane whose queue dropped nothing (where the
            8,192-slot queue overflows, every missing delivery counted
            in ``dropped`` and ``evq_peak`` at the capacity), and
            ``bcn_skew_max > 0`` on every lane; seed 1 of ``shared_bus``,
            ``hier_tree`` and ``mesh2d`` at k=16 in ``"seq"`` mode (the
            single loop), equal to its vmap lane where the phase ran one
            at its horizon and to the frozen digest's counters of its
            lane; events/s of
            each group in both modes; and at
            sim_len 2e4 (``hier_tree``) device kernels and busy time per
            step, split into steps where every lane delivers a beacon
            and the rest (the loop's step spans under
            ``torch.profiler``, lane steps 51-250), and host reads per
            step (every counted run of phases 12-15 stops at its
            window's last step);
13. queues  the tree and calendar event queues and the same-timestamp
            BEACON_RX batch window (``batch_pop``) through the lane
            loop at the same tier, seeds 1-2: at k=16 on ``hier_tree`` every
            queue with batch_pop 1 at
            sim_len 1e4 (2e4 until phase 28) equal to the linear queue
            leaf for leaf (but the queue's own leaves), and with
            batch_pop 64 at 2.5e4 (1e5, then 5e4, until phase 28) equal
            to ``goldens.FABRICS``; the tree queue
            with batch_pop 64 at k=32 on ``hier_tree`` and ``mesh2d`` at
            2.5e4 (1e5, then 5e4 before) equal to ``goldens.FABRICS``;
            the tier's cut points: k=1 at 5e4 (2.5e5, then 1e5,
            before; linear queue), and k=256 (32,768 slots, tree/64)
            on ``hier_tree`` and ``mesh2d`` at 5e4 (cut from 1e5),
            equal to
            ``goldens.CUTS``; conservation and
            an empty ``bcn_t`` on every drop-free lane; seed 1 of the
            k=16 tree/64 run in ``"seq"`` mode equal to its vmap lane;
            steps and events/s of every run (the k=16 ones against phase
            ``fabrics``' linear run at 5e4), and of each k=16 combo at
            sim_len 2e4 (linear/1's from phase 12) the kernels, device
            busy time and host reads a step, split by step kind;
14. faults  fault injection and the failure detector through the lane
            loop at the same tier (k=16, linear queue, 2 lanes a group,
            sim_len 5e4 (cut from 1e5 for the time limit), the fault
            times scaled to it; the groups of
            ``goldens.fault_specs``): ``hier_tree`` under no fault,
            Poisson link failures, a partition and GMN churn, ``mesh2d``
            under the partition, and the detector tier under a
            power-domain outage (``min_search``, ``avoid_suspected``,
            ``suspect_weighted`` under periodic beacons,
            ``avoid_suspected`` under heartbeat) against
            ``goldens.FAULTS``; the no-fault group also against
            ``goldens.FABRICS`` (and its events/s beside phase 12's
            no-fault probe on the same lanes at 5e4); ``beacons_rx + msgs_lost
            == (k-1) * beacons_tx + retries_tx`` on drop-free lanes,
            every arrived application complete, the partition's outage
            exactly in ``downtime``; seed 1 of the partition group in
            ``"seq"`` mode equal to its vmap lane; events/s of each
            group; at sim_len 2e4 the kernels, device busy time and host
            reads a step of the no-fault group (steps 51-250, as phase
            12's linear/1) and of the outage group inside its outage
            (steps 301-700);
15. trace   the in-loop trace (``core/trace``) with ``trace_report``'s
            TraceSpec (ring 16,384, stride 64, 512 samples, 64 bins, 4
            per octave), 60 s budget: (a) the paper point through
            ``sim.run`` at sim_len 2.5e5 (1e6 until the script took
            phase 27) against phase 9's untraced timed run;
            (b) the k=16 ``hier_tree`` group of phase 12's tier (linear
            queue, seeds 1-2) at 5e4 (1e5 until phase 29 came) through
            the lane loop against
            phase 12's untraced probe; (c) k=16 ``hier_tree`` on the
            tree queue with batch_pop 64 under a partition at 2e4 with a
            1,024-row ring that overflows, against its untraced run.
            Gates: every shared leaf bitwise, the trace leaves against
            ``goldens.TRACE`` (the JAX reference's), every lane's
            ``TraceFrame.check()``, ``validate_perfetto`` empty.
            Reported: events/s on and off (the gated runs, and in turns
            — off, on, on, off — at 2.5e4 (a) and 2e4 (b)), kernels,
            device busy time and syncs an event of (a) at 2.5e4 and a step
            of (b) at 2e4 by step kind (against phase 12's count), the
            p50/p95/p99 columns;
16. lm_small   the reduced 8-layer Jamba (f32, the port's seeded init)
            forward on the card (K2, K3) against the same weights on
            the CPU (plain versions);
17. lm_prefill the full-width 16-layer Jamba in bf16: one
            ``make_prefill_step`` call on 2 x 4096 tokens must launch K2
            twice and K3 14 times and give finite logits; then timed
            (tokens/s) and profiled (device time by kernel);
18. lm_serve   ``launch.serve.serve`` on the same config in bf16: its
            dict must equal ``goldens.SERVE``; decode ms per step;
19. k2_bwd     K2's forward with ``lse`` and the attention backward
            (``csrc/flash_attention_bwd.cu``) against their plain
            versions in f32 and bf16, at olmo_1b's training shape (B=4,
            S=2048, Hq=Hkv=16, D=128, causal) and on GQA, windowed,
            Sq < Skv and ragged cases, and phase 4's cases of the last
            five families (Sq > Skv without a mask among them); two
            backward launches must give
            the same bits; the backward's kernel, plain, bound and
            ``scaled_dot_product_attention`` backward times at the
            training shape, the f32 backward's time, and each backward
            kernel's device time in both dtypes (``torch.profiler``); a
            bf16 ``dout`` that is not 16-byte aligned must raise; K2 at
            the prefill shape with ``lse`` off and on, in turns;
20. k3_bwd     the scan's backward (``csrc/selective_scan_bwd.cu``)
            from the forward's run-start states, against its plain
            version in f32 and bf16 (f32 A), on the JAX tests' scan
            cases, S and Di that are not multiples of its runs, stages,
            channel blocks or clusters, N in {1, 4, 16, 64}, B = 1 and
            falcon_mamba_7b's training shape (B=4, S=2048, Di=8192,
            N=16): each gradient within 1e-4 (f32) or 2e-2 (bf16) of its
            largest magnitude, two launches bit-equal (the second
            without states, which makes them first); kernel, plain and
            bound times, each of its two kernels' device time, its run,
            stage, cluster size, shared memory a block, resident blocks
            an SM and clusters, and phase 2's registers and
            ``MUFU.EX2`` counts, at the training shape;
21. lm_train_small  the reduced olmo of tests/test_train_loop.py in f32:
            three ``make_train_step`` steps (plain, microbatches=2,
            int8) on the card against the same steps on the CPU; then
            the reduced falcon_mamba_7b, deepseek_moe_16b, mixtral_8x22b
            (window 16 over 32 tokens), Jamba, qwen2_72b, glm4_9b,
            minicpm_2b, whisper_medium and internvl2_2b (their frames and
            patches in f32) the same way (plain), the scan's backward
            launched for falcon and Jamba;
22. lm_train   olmo_1b at full width in bf16 through
            ``launch.train.train``: 8 steps at batch 4 x 2048 from a
            seeded init; 32 K2 and 16 backward launches a step, finite
            losses, the last below the first; ms per step, tokens/s,
            peak memory, device time by kernel group of one more step;
23. lm_train_ssm  falcon_mamba_7b at full width cut to 16 of 64 layers
            (2.22 B parameters), the same run: 32 launches of K3's
            training variant and 16 of the scan's backward a step, no
            K2;
24. lm_train_moe  deepseek_moe_16b at full width cut to 6 of 28 layers
            (3.44 B parameters), the same run: 11 K2 and 6 backward
            launches a step (layer 0 is outside remat); the router's
            load balance and dropped fraction of the profiled step;
25. lm_families  the last five families at full width in bf16, seeded
            weights: qwen2_72b (16 of 80 layers, 16.5 B parameters),
            glm4_9b (40 layers), minicpm_2b (40), internvl2_2b (24) and
            whisper_medium (24 + 24) each through ``make_prefill_step``
            on 2 x 4096 tokens (whisper: 2 x 2048 text tokens against
            1,500 frames; internvl: 256 patch tokens and 3,840 text
            tokens), one K2 launch a self-attention layer (whisper: also
            one a cross attention and one an encoder layer), finite
            logits, tokens/s; then 8 ``decode_step``s at batch 4 (whisper
            from the cross cache of its encoder's output), no K2 launch,
            ms a step; then the training run of phase 22 for glm4_9b cut
            to 8 layers, minicpm_2b under its WSD schedule, internvl2_2b
            (256 patch tokens and 1,792 text tokens) and whisper_medium
            (2,048 text tokens against 1,500 frames): each forward K2
            launch twice a step under remat ``full``, each backward once;
26. shard      the sharded cell (``launch/steps.build_cell``) on the
            card: a one-rank NCCL group on an in-memory store and
            ``make_host_mesh`` (1x1); three olmo_1b training steps at
            full width (bf16, remat ``full``, batch 4 x 2048) through the
            cell's step on DTensor parameters, the losses and every
            parameter after step 3 equal to the unsharded
            ``make_train_step``'s bit for bit, K2 and its backward
            launched 32 and 16 times a step, the last step counted by
            ``launch/op_cost``; beside it, in two subprocesses, the dry
            run (``launch/dryrun``) of that cell on a 1x1 mesh and of
            olmo_1b ``decode_32k`` on 16x16: the 1x1 prediction's peak
            within 25% of ``torch.cuda.max_memory_allocated`` over the
            sharded steps, its FLOPs equal to the real step's count;
            predicted terms, peak and FLOPs of both cells beside the
            card's name and power limit;
27. loop_copy  ``analysis.loop_copy.lint_combo`` at the analysis CLI's
            ``paper`` combos (m=256, k=256, ``hier_tree``, queue_cap
            32,768, batch_pop 64, tree and calendar queues, one lane):
            lane steps 21-60 under a ``TorchDispatchMode`` that records
            every copy and factory op and under ``torch.profiler``; no
            finding (no copy of >= queue_cap or k*k elements, copied
            bytes a step within the reference's copy budget), copy
            kernels, their device time and bytes a step, in at most 15 s;
28. suite      ``benchmarks/run.py``'s step wrapper (``run.Suite``) under
            its profiler (``run.profiler``: CPU and CUDA; collection
            kept for the first loop steps of each step), within
            ``SUITE_BUDGET_S``: ``scheduler_overhead`` (K1 against its
            plain version; its sweep-engine bench cut), the frontier
            runners ``fault_frontier``, ``policy_frontier`` and
            ``trace_report`` at ``goldens.SUITE_GRIDS`` (the tests'
            grids cut where every claim still holds; every claim true,
            their row digests equal to the JAX reference's,
            ``goldens.SUITE_DIGESTS``), ``topology_frontier`` at
            tests/test_torch_paper.py's TINY_TREE (cut to sim_len 3e4,
            two fabrics and k in (4, 16)) twice into a
            temporary trajectory, each run recording its combos' copy
            bytes anew, and ``check_regression.check`` of the second
            against the first (every row on both sides, every copy entry
            ``ok`` at a ratio of 1.0; throughput statuses and the worst
            ratio reported), the two examples (``paper_repro_torch`` at
            sim_len 1e5, its numbers equal to the reference example's,
            ``goldens.PAPER_REPRO``; ``serve_clustered_torch``, its
            ``serve`` dict equal to ``goldens.SERVE_CLUSTERED``) and
            ``ExperimentSpec.run(mode="pmap")`` on the golden grid and
            the same grid at k=2: vmap on one card, the golden group bit
            for bit phase 11's golden grid, and dispatched through the
            device list to two workers on cuda:0 (a group on each
            worker's thread, the two lane loops at once) bit for bit
            the same; the exported Chrome trace holds one region a step,
            each with a CUDA kernel;
29. replay     (run after phase 15) the decision replay
            (``serving/replay.py``): ``sim.run`` with ``record_s1`` at
            m=64, k=8, interference seed 0, sim_len 3e5 under
            ``min_search`` and ``staleness_weighted``, the ``dec_*``
            leaves, events and ``app_done`` bit for bit the JAX
            reference's (``goldens.REPLAY``), every recorded decision
            replayed through the wall-clock ``ClusterScheduler`` with no
            mismatch, ``replay_trace`` driving a ``FleetSim`` until every
            recorded application is finished; K1's launches read;
30. lm_train_remat  (run after phase 24) phases 22 and 23's runs
            (olmo_1b, falcon_mamba_7b cut to 16 layers) under remat
            ``none`` and ``dots``: launches a step as the policy implies
            (K2 16 and 32, K3's training variant 16 and 32, each backward
            16), the 8 losses bit for bit remat ``full``'s, the peak
            memory; beside them, in subprocesses, the dry run of
            olmo_1b's 1x1 cell under each policy and under
            microbatches=2 (the CLI) and of falcon's cut cell: olmo_1b's
            peaks within 25% of the measured and its FLOPs equal to a
            real step's count (``launch/op_cost``), falcon's reported;
31. lm_train_accum  olmo_1b at full width under microbatches=2 (K2 64
            and 32 backward launches a step) and int8 compression (32
            and 16): finite losses, the last below the first, each within
            ``LM_ACCUM_TOL`` of phase 22's (int8's first bit for bit);
            microbatches=2's peak and FLOPs against its dry run; peaks
            beside phase 22's;
32. lm_resume  olmo_1b at full width cut to 4 layers in bf16 through
            ``launch.train.train``: 8 steps uninterrupted, then a
            checkpoint every 4 steps (a temporary directory) and a
            failure injected at step 6, then resumed from step 4:
            parameters, moments and step counter after step 8 bit for
            bit the uninterrupted run's; in subprocesses started before
            phase 30 (beside phases 30-32), the train CLI's crash
            (``--fail-at 12``, non-zero exit) and resume (``resumed
            from step 10``, exit 0) and the serve CLI (64 of 64
            requests finished), read at this phase's end;
33. paper_suite  (run after phase 28) the steps of ``benchmarks/run.py``
            no other phase runs and the examples the card had not run,
            each through ``run.Suite.step``, within
            ``PAPER_SUITE_BUDGET_S``: ``fig2a`` and ``fig2b`` at the
            reference's arguments (fig2b: k 1-256, c_s 1/8/64, sim_len
            1e7, the ``independent`` workload; ``fit_ok`` and the
            float32 bits of its 27 curve points equal to the JAX
            reference's, ``goldens.FIG2B``); ``baseline_compare``, the
            paper's headline comparison, at its full grid (k 1, 16, 256,
            pair periods 2e4, 1.4e4, 1e4, seeds 1-2) cut in horizon only
            to 1e5 (from 2e6): every rate's clustered k=16 beats both
            baselines and each k's digest equals the reference's
            (``goldens.BASELINE``); ``moe_balance`` on inputs drawn on
            the CPU and moved to the card, against the same call on the
            CPU (exact where no token's second and third router logits
            lie within ``MOE_TIE_EPS``); ``examples/train_tiny_lm_torch.py``
            (114 M parameters, f32: K2's CUDA-core kernel and the f32
            backward) with ``--crash-demo`` cut to 60 steps, the resumed
            run's parameters, moments and losses bit for bit an
            uninterrupted ``train`` of its config, the losses finite and
            falling, K2 and its backward launched as the config implies;
            ``examples/quickstart_torch.py`` on glm4_9b (its default)
            and falcon_mamba_7b (K3), its losses against its CPU run,
            its launches as the reduced config implies;
            ``roofline_report.render`` of phase 26's two dry-run rows at
            their mesh, every row rendered and ``ok``;
34. tlm_device  (run after phase 7) the event-loop kernel
            (``csrc/tlm_loop.cu``: every lane's whole run of the paper's
            program in one launch) against its plain version, the host
            loop (``lanes.simulate_lanes_host``), on the golden grid,
            the paper point at 1e6, fig3a's k=16 and k=1 groups at 5e4,
            fig3b's k=32 group at 2.5e5, Table 5's k=256 group at 1e5
            and ``baseline_compare``'s k=16 group at 1e5: two runs a
            group, one launch each (the second, warm, reported), every
            leaf bit for bit but ``mgmt_latency`` (rtol 1e-5), the
            frozen digests where they exist; each group's events, the
            launch's device time (CUDA events around it), walls and
            events/s in both loops;
35. paper_full  (run after phase 33) ``fig3a``, ``fig3b`` and
            ``table5`` at sim_len 4e6 and ``baseline_compare`` at 2e6,
            the reference's own arguments and full grids, each through
            ``run.Suite.step``: the rows digest and every claim equal to
            the reference runner's (``goldens.PAPER_FULL``), one
            ``tlm_loop`` launch a k group, within
            ``PAPER_FULL_BUDGET_S``;

then a line of each phase's seconds, the ``tlm_loop`` launches of each
path, the ``kernels`` line and, last, the ``{"ok": true, "device":
...}`` line.  Each main path reads its own launch counts, zeroed just
before it and read just after: ``tlm_loop`` on every path that runs
the paper's program (phases 6, 7, 10's covered run, 11, 13's k=1
group, 28's ``policy_frontier``, ``pmap`` and ``paper_repro``, 33's
``fig2b`` and ``baseline_compare``, 34 and 35; one launch a lane
group, two in 34) and on none of those of the host loop alone (9, 12, 14, 15, 27,
29); the TLM path (phases 7-8: K1), the sweep (phase 11), the fabrics
(phase 12), the queues (phase 13), the faults (phase 14), the trace (phase 15) and the
loop-copy check (phase 27), which launch none of the three kernels, the
replay (phase 29: K1's launches read), the
suite (phase 28: K1, from ``scheduler_overhead``), the paper suite
(phase 33: each step's launches read around it, the comparison runs'
left out; K2 and its backward from the tiny LM and the quickstart, K3,
its training variant and its backward from the SSM quickstart, no K1),
the prefill (phase
17: K2, K3), ``serve()`` (phase 18, whose decode steps are plain
torch), the training runs (phases 22-24 and 30-32: K2 and its backward,
K3's training variant and the scan's backward; phase 32's CLI
subprocesses count in their own processes), each family's
prefill, decode and training in phase 25 (K2 and its backward) and the
sharded steps of phase 26 (K2 and its backward); the ``kernels`` line
gives K3 and its training variant a row each.  The comparison
launches of phases 3-5, 16, 19, 20 and 21 do not count.  Float32
matmuls run in full float32 (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False) so the f32
comparisons hold the kernels, not TF32 rounding.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# the time limit the on-card smoke runs get (the tool's default call
# limit), nvcc builds included
TIME_LIMIT_S = 900.0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 peak outside tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core peak
KERNEL_SOURCES = ("hier_minsearch", "flash_attention",
                  "flash_attention_bwd", "selective_scan",
                  "selective_scan_bwd", "tlm_loop")
K1_KS = (1, 8, 16, 32, 256)
K1_M, K1_T, K1_MAIN_K = 256, 100, 16
# ragged shapes, and one above the warp kernel's capacity (block only)
K1_ODD, K1_BLOCK_ONLY = ((5, 7), (37, 3)), (64, 64)
K1_KERNEL_NAMES = ("assign_warp", "assign_block", "empty_kernel")
BWD_KERNEL_NAMES = ("bwd_delta", "bwd_dkdv", "bwd_dq")
SETUP_SYNCS_MAX = 32           # host<->card copies of a run's set-up


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, rounds: int, per_round: int = 1, warmup: int = 3) -> float:
    """Median over ``rounds`` of CUDA-event time per call, each round
    timing ``per_round`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_round):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_round)
    return statistics.median(times)


def k1_bound_ms(k: int, mpk: int, n_tasks: int):
    """Least time for the mapper's work on the card: the larger of its
    bytes (loads in and out, costs in, assignments out) over the memory
    rate and its f32 operations (row sums, the two argmin scans, the
    update, per task) over the f32 peak."""
    bytes_ms = (2 * k * mpk + 3 * n_tasks) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = n_tasks * (k * mpk + k + mpk + 1) / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count(),
          "kind": torch.cuda.get_device_name(0)})
    return smi


def _ptxas(log: str, demangle) -> dict:
    """Registers, stack frame and spill bytes (stores + loads) of each
    kernel in ``nvcc -Xptxas -v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = demangle(m.group(1))
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn]["stack_bytes"] = int(m.group(1))
            out[fn]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import selective_scan as SS
    bin_dir = Path(_build.nvcc_path()).parent

    def timed(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    def demangle(sym):
        tool = shutil.which("cu++filt", path=str(bin_dir))
        if tool is None:
            return sym
        name = subprocess.run([tool, sym], capture_output=True,
                              text=True).stdout.strip() or sym
        # "void <unnamed>::tc::f<(int)128>(args)" -> "tc::f<128>"
        name = re.sub(r"\((int|bool)\)", "", name).split("(")[0]
        return re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "",
                      name)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = dict(zip(KERNEL_SOURCES, pool.map(timed, KERNEL_SOURCES)))
    wall = time.perf_counter() - t0
    kernels = {}
    for name in KERNEL_SOURCES:
        kernels.update(_ptxas(_build.build_log(name).read_text(), demangle))
    sass = _sass(bin_dir, built["flash_attention"][0], demangle)
    hgmma = sum("HGMMA" in line for lines in sass.values() for line in lines)
    if hgmma == 0:
        raise AssertionError("K2's library holds no HGMMA instruction: the "
                             "bf16 kernel does not use the tensor cores")
    # the backward's bf16 kernels (tc::bwd_dkdv<D>, tc::bwd_dq<D>): every
    # instance must hold HGMMA
    bwd_tc = {fn: {**kernels.get(fn, {}), "HGMMA": sum(
        "HGMMA" in ln for ln in lines)}
        for fn, lines in _sass(bin_dir, built["flash_attention_bwd"][0],
                               demangle).items()
        if re.match(r"tc::bwd_(dkdv|dq)<", fn)}
    if len(bwd_tc) != 2 * len(FA.HEAD_DIMS) or any(
            v["HGMMA"] == 0 for v in bwd_tc.values()):
        raise AssertionError(f"the backward's bf16 kernels: want HGMMA in "
                             f"each of tc::bwd_dkdv and tc::bwd_dq at D in "
                             f"{FA.HEAD_DIMS}, got {bwd_tc}")
    k1_warp = {}
    for fn, lines in _sass(bin_dir, built["hier_minsearch"][0],
                           demangle).items():
        if fn.startswith("assign_warp"):
            k1_warp[fn] = {**kernels[fn], **{
                op: sum(bool(re.search(rf"\b{op}\b", ln)) for ln in lines)
                for op in ("REDUX", "BAR")}}
    if not k1_warp or any(
            v["REDUX"] == 0 or v["BAR"] != 0 or v.get("spill_bytes") != 0
            or v.get("stack_bytes") != 0 for v in k1_warp.values()):
        raise AssertionError(f"K1's warp kernel: want REDUX, no BAR, no "
                             f"spills and no stack in every instance, got "
                             f"{k1_warp}")
    # the scan's backward: no instance may spill; each one's MUFU.EX2
    # (the exponential's SFU op) count, against one a recomputed
    # state-step of its unrolled run (RUN x 4 states) and none in the walk
    # back
    k3_bwd = {}
    for fn, lines in _sass(bin_dir, built["selective_scan_bwd"][0],
                           demangle).items():
        if fn.startswith("ssm_scan_bwd<"):
            k3_bwd[fn] = {**kernels.get(fn, {}), "MUFU.EX2": sum(
                "MUFU.EX2" in ln for ln in lines), "recomputed": 4 * SS.RUN}
    if not k3_bwd or any(v.get("spill_bytes") != 0
                         or v["MUFU.EX2"] > v["recomputed"]
                         for v in k3_bwd.values()):
        raise AssertionError(f"the scan's backward: want no spills and at "
                             f"most one MUFU.EX2 a recomputed state-step in "
                             f"every ssm_scan_bwd instance, got {k3_bwd}")
    # the event-loop kernel: no FFMA (every f32 add and product rounded
    # on its own, as the host loop's), no spills
    tlm = {fn: {**kernels.get(fn, {}), "FFMA": sum(
        bool(re.search(r"\bFFMA\b", ln)) for ln in lines)}
        for fn, lines in _sass(bin_dir, built["tlm_loop"][0],
                               demangle).items()}
    if not tlm or any(v["FFMA"] or v.get("spill_bytes") != 0
                      for v in tlm.values()):
        raise AssertionError(f"the event-loop kernel: want no FFMA and no "
                             f"spills, got {tlm}")
    emit({"phase": "build", "libraries": {n: b[0] for n, b in built.items()},
          "seconds": {n: b[1] for n, b in built.items()}, "wall_s": wall,
          "ptxas": kernels, "k3_bwd": k3_bwd, "tlm_loop": tlm,
          "k2_hgmma_instructions": hgmma,
          "k2_bwd_bf16": bwd_tc, "k1_warp": k1_warp,
          "spill_free": all(k.get("spill_bytes", 0) == 0
                            for k in kernels.values())})
    return k3_bwd


def _sass(bin_dir: Path, lib: str, demangle) -> dict:
    """The SASS lines of each kernel in a built library
    (``cuobjdump -sass``), by demangled name."""
    text = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = demangle(m.group(1))
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return out


def _k1_cases():
    """(label, loads, costs, exact) on the host; exact = integer data,
    where loads must match bit for bit (NaN where the plain version has
    NaN)."""
    rng = np.random.default_rng(0)
    nan, inf = np.nan, np.inf
    cases = []
    for k in K1_KS:
        mpk = K1_M // k
        cases.append((f"unit k={k}", np.zeros((k, mpk), np.float32),
                      np.ones(K1_T, np.float32), True))
        cases.append((f"float k={k}",
                      (rng.random((k, mpk)) * 5).astype(np.float32),
                      (rng.random(K1_T) + 0.5).astype(np.float32), False))
    cases.append(("all-zero tie 3x3", np.zeros((3, 3), np.float32),
                  np.ones(9, np.float32), True))
    nan_cost = rng.integers(1, 4, 10).astype(np.float32)
    nan_cost[5] = nan
    cases += [
        ("nan in a row", np.array([[1, 2], [nan, 0], [3, 4]], np.float32),
         np.ones(3, np.float32), True),
        ("all nan 2x2", np.full((2, 2), nan, np.float32),
         np.ones(3, np.float32), True),
        ("nan cost at step 5 of 10",
         rng.integers(0, 5, (4, 4)).astype(np.float32), nan_cost, True),
        ("+inf, -inf and nan-sum rows",
         np.array([[inf, 1], [2, -inf], [inf, -inf], [0, 0]], np.float32),
         np.ones(5, np.float32), True),
        ("-inf row", np.array([[5, 1], [2, -inf], [0, 0]], np.float32),
         np.ones(4, np.float32), True),
        ("all +inf 3x3", np.full((3, 3), inf, np.float32),
         np.ones(5, np.float32), True),
        ("-0.0 beside +0.0",
         np.array([[0.0, -0.0], [-0.0, 0.0], [-0.0, -0.0]], np.float32),
         np.ones(4, np.float32), True),
    ]
    for k, mpk in (*K1_ODD, K1_BLOCK_ONLY):
        cases.append((f"float {k}x{mpk}",
                      (rng.random((k, mpk)) * 5).astype(np.float32),
                      (rng.random(K1_T) + 0.5).astype(np.float32), False))
        cases.append((f"ties {k}x{mpk}",
                      rng.integers(0, 3, (k, mpk)).astype(np.float32),
                      np.ones(K1_T, np.float32), True))
    return cases


def _k1_compare(a_k, l_k, a_p, l_p, exact: bool):
    """(assignments equal, loads equal, max abs err): NaN only where the
    plain version has NaN; elsewhere bit for bit if ``exact``, else
    within 1e-5 (equal infinities count as 0)."""
    import torch
    nan_p = torch.isnan(l_p)
    keep = ~nan_p
    x, y = l_k[keep], l_p[keep]
    diff = torch.where(x == y, 0.0, (x - y).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    same = (torch.equal(x.view(torch.int32), y.view(torch.int32)) if exact
            else err <= 1e-5)
    return (torch.equal(a_k, a_p),
            same and torch.equal(torch.isnan(l_k), nan_p), err)


def _k1_device_ms(groups, reps: int) -> dict:
    """Median device time (ms) per launch of each (label, fn) group, fn
    launching one K1 kernel, from ``torch.profiler``'s kernel records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _, fn in groups:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, fn in groups:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    recs = sorted((e.start_ns(), e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and any(w in e.name() for w in K1_KERNEL_NAMES))
    if len(recs) != len(groups) * reps:
        raise AssertionError(f"k1: {len(recs)} profiled kernels for "
                             f"{len(groups)} x {reps} launches")
    return {label: statistics.median(
        d for _, d in recs[i * reps:(i + 1) * reps]) / 1e6
        for i, (label, _) in enumerate(groups)}


def phase_k1():
    import torch
    from repro_torch.kernels import hier_minsearch as HM
    rows, worst = [], 0.0
    for label, loads_h, costs_h, exact in _k1_cases():
        loads = torch.from_numpy(loads_h).cuda()
        costs = torch.from_numpy(costs_h).cuda()
        k, mpk = loads_h.shape
        a_p, l_p = HM.assign_tasks_plain(loads, costs)
        variants = ("warp", "block") if k * mpk <= HM.WARP_MAX_N \
            else ("block",)
        if HM._variant(k, mpk) != variants[0]:
            raise AssertionError(f"k1 {label}: the wrapper picks "
                                 f"{HM._variant(k, mpk)}, not {variants[0]}")
        row = {"case": label, "k": k, "mpk": mpk, "T": len(costs_h),
               "variants": list(variants)}
        for v in variants:
            a_k, l_k = HM._launch(loads, costs, v)
            torch.cuda.synchronize()     # a fault in the run shows here
            same_a, same_l, err = _k1_compare(a_k, l_k, a_p, l_p, exact)
            if not (same_a and same_l):
                raise AssertionError(f"k1 {label}: the {v} kernel and the "
                                     f"plain version disagree (assignments "
                                     f"equal: {same_a}, loads equal: "
                                     f"{same_l}, max err {err})")
            worst = max(worst, err)
            row[f"{v}_max_abs_err"] = err
        if len(variants) == 1:
            before = HM.launches
            try:
                HM._launch(loads, costs, "warp")
                raise AssertionError(f"k1 {label}: the warp kernel took a "
                                     f"shape above its capacity")
            except ValueError:
                pass
            if HM.launches != before:
                raise AssertionError(f"k1 {label}: a refused call launched")
        rows.append(row)
    # times at the m=256 shapes on all-zero loads, unit costs
    timed, groups = [], [("empty", HM.empty_launch)]
    for k in K1_KS:
        loads = torch.zeros((k, K1_M // k), device="cuda")
        costs = torch.ones(K1_T, device="cuda")
        timed.append((k, loads, costs))
        for v in ("warp", "block"):
            groups.append((f"{v} k={k}", lambda loads=loads, costs=costs,
                           v=v: HM._launch(loads, costs, v)))
    device_ms = _k1_device_ms(groups, reps=20)
    times = []
    for k, loads, costs in timed:
        row = {"k": k, "mpk": K1_M // k, "T": K1_T}
        for v in ("warp", "block"):
            row[f"{v}_ms"] = device_ms[f"{v} k={k}"]
            row[f"{v}_us_per_decision"] = row[f"{v}_ms"] * 1e3 / K1_T
            row[f"{v}_call_ms"] = cuda_ms(
                lambda: HM._launch(loads, costs, v), rounds=10, per_round=10)
        row["plain_ms"] = cuda_ms(
            lambda: HM.assign_tasks_plain(loads, costs), rounds=5)
        row["bound_ms"], row["bound_by"] = k1_bound_ms(k, K1_M // k, K1_T)
        times.append(row)
    empty = {"device_ms": device_ms["empty"],
             "call_ms": cuda_ms(HM.empty_launch, rounds=10, per_round=10)}
    main = next(r for r in times if r["k"] == K1_MAIN_K)
    emit({"phase": "k1", "cases": rows, "all_match": True, "times": times,
          "empty_launch": empty, "warp_max_n": HM.WARP_MAX_N})
    return {"max_abs_err": worst, "ms": main["warp_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"]}


def phase_golden():
    import torch
    from repro_torch.core import goldens as G
    t0 = time.perf_counter()
    got = G.golden_grid("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = got.pop("events")
    want = {"beacons_tx": G.GRID_BEACONS,
            "app_done_sha": G.GRID_APP_DONE_SHA,
            "single_app_done": G.SINGLE_APP_DONE,
            "single_app_beacons": G.SINGLE_APP_BEACONS}
    if got != want:
        raise AssertionError(f"golden grid on the card: {got} != {want}")
    emit({"phase": "golden", "match": True, **got, "wall_s": wall,
          "events": events, "events_per_s": events / wall})


PROFILE_SIM_LEN = 1e6     # the paper point's --fast horizon, 13,824 events
# phase profile's horizon (3,456 events): cut from 1e6 in PR 25 for the
# script's time, with its own untraced timed run
PROFILE_CUT_SIM_LEN = 2.5e5


def _paper_run(sim_len: float):
    """(params, workload) of the paper point at ``sim_len``."""
    from repro_torch.core import goldens as G
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    p = SimParams()
    return p, W.interference(p, sim_len=sim_len, seed=G.PAPER_SEED)


def _check_paper(st, sim_len: float, phase: str) -> int:
    from repro_torch.core import goldens as G
    got = G.paper_point_digest(st)
    if got != G.PAPER_POINT[sim_len]:
        raise AssertionError(f"{phase}: paper point sim_len={sim_len:g} "
                             f"{got} != {G.PAPER_POINT[sim_len]}")
    return got["events_processed"]


def phase_paper():
    """The paper point at PROFILE_SIM_LEN, timed, against the frozen
    digests; its run is also phase ``profile``'s untimed baseline and
    phase ``trace``'s untraced run."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core.sim import run
    p, wl = _paper_run(PROFILE_SIM_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(p, *wl, PROFILE_SIM_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _check_paper(st, PROFILE_SIM_LEN, "paper")
    emit({"phase": "paper", "match": True, "sim_len": PROFILE_SIM_LEN,
          **G.paper_point_digest(st), "wall_s": wall,
          "events_per_s": events / wall,
          "m": p.m, "k": p.k, "n_childs": p.n_childs,
          "queue_cap": p.queue_cap, "max_apps": p.max_apps})
    return {"state": st, "wall_s": wall, "events": events}


def phase_mapper():
    import torch
    from repro_torch.core.mapping import MapperState, map_batch, map_one
    from repro_torch.kernels import hier_minsearch as HM
    k = K1_MAIN_K
    state = MapperState.create(k, K1_M // k)
    before = HM.launches
    assigns, new = map_batch(state, np.ones(K1_T, np.float32))
    (c, u), one = map_one(new, 1.0)
    want_a, want_l = HM.assign_tasks_plain(
        state.loads, torch.ones(K1_T + 1, device="cuda"))
    torch.cuda.synchronize()
    if HM.launches - before != 2:
        raise AssertionError(f"map_batch + map_one launched the kernel "
                             f"{HM.launches - before} times, not 2")
    if not (torch.equal(assigns, want_a[:K1_T])
            and [c, u] == want_a[K1_T].tolist()
            and torch.equal(one.loads, want_l)
            and torch.equal(one.view, want_l.sum(dim=1))):
        raise AssertionError("mapper entry point disagrees with the plain "
                             "version on the card")
    emit({"phase": "mapper", "match": True, "k": k, "m_per_k": K1_M // k,
          "T": K1_T, "kernel_launches": HM.launches - before})


def phase_profile():
    """Device busy share of the host event loop (``sim.simulate_host``,
    the ``tlm_loop`` kernel's plain version) at the paper point (sim_len
    PROFILE_CUT_SIM_LEN): CUDA kernel time over wall time, against a run
    of it timed without the profiler.  The profiled run is also under
    torch's sync debug mode: returns its events and host syncs by line
    for :func:`phase_syncs`, and its timed run (state, wall, events) for
    phase ``trace``'s untraced baseline."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    p, wl = _paper_run(PROFILE_CUT_SIM_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = _run_host(p, *wl, PROFILE_CUT_SIM_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _check_paper(st, PROFILE_CUT_SIM_LEN, "profile")
    timed_run = {"state": st, "wall_s": wall, "events": events}

    def profiled():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st = _run_host(p, *wl, PROFILE_CUT_SIM_LEN)
            torch.cuda.synchronize()
            return st, prof, time.perf_counter() - t0
    (st, prof, wall_prof), lines = _sync_lines(profiled)
    _check_paper(st, PROFILE_CUT_SIM_LEN, "profile")
    # the raw kineto records: millions of them, too many to build the
    # profiler's Python event tree from
    busy_ns, n_dev, by_name = 0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ns = e.duration_ns()
        busy_ns += ns
        n_dev += 1
        name = e.name()[:60]
        by_name[name] = by_name.get(name, 0) + ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "profile", "loop": "host", "sim_len": PROFILE_CUT_SIM_LEN,
          "events": events,
          "wall_s": wall, "events_per_s": events / wall,
          "wall_s_profiled": wall_prof, "device_kernels": n_dev,
          "kernels_per_event": n_dev / events,
          "device_busy_us": busy_ns / 1e3,
          "device_busy_us_per_event": busy_ns / 1e3 / events,
          "device_busy_share": busy_ns / 1e9 / wall,
          "device_busy_share_profiled": busy_ns / 1e9 / wall_prof,
          "top_kernels_us": [[n, ns / 1e3] for n, ns in top]})
    return events, lines, timed_run


def _sync_lines(run):
    """``(run(), Counter of source lines)``: every call in ``run`` that
    waits for the card, under torch's sync debug mode (which warns at
    each), by the file and line that made it."""
    import warnings
    from collections import Counter
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, Counter(f"{Path(r.filename).name}:{r.lineno}" for r in rec
                        if "synchronizing" in str(r.message))


def _lint_guard(lines):
    """The static guard against the card's count of host syncs by line
    (``file.py:N``): ``analysis.lint`` finds nothing in the port's core
    and serving files, the most frequent line (the packed read) carries
    its ``allow(host-sync)`` pragma, and every other line lies outside
    the loop path the lint computes.  Returns (loop-path lines, the
    lines checked outside it)."""
    from repro_torch.analysis import lint as L
    from repro_torch.analysis.__main__ import lint_files
    files = lint_files()
    findings = L.lint_paths(files)
    if findings:
        raise AssertionError("syncs: the lint finds "
                             f"{[f.to_dict() for f in findings]}")
    path = L.loop_path(files)
    on_path = {f"{Path(f).name}:{n}" for f, ns in path.items() for n in ns}
    src = {Path(f).name: Path(f).read_text().splitlines() for f in files}
    read_line = lines.most_common(1)[0][0]
    name, n = read_line.rsplit(":", 1)
    text = src.get(name, [""] * int(n))[int(n) - 1]
    if read_line not in on_path \
            or not L.PRAGMA_RE.search(text) \
            or "host-sync" not in L.PRAGMA_RE.search(text).group(1):
        raise AssertionError(f"syncs: the packed read {read_line} is not "
                             "an allowed host sync on the lint's loop path")
    inside = [ln for ln in lines if ln != read_line and ln in on_path]
    if inside:
        raise AssertionError(f"syncs: host syncs on the loop path the "
                             f"lint passed: {inside}")
    return len(on_path), sorted(ln for ln in lines if ln != read_line)


def _sync_sequence(run):
    """``(run(), the calls that waited for the card in order)``, under
    torch's sync debug mode, each as its ``file.py:N``, with ``"launch"``
    where each ``tlm_loop`` launch returned."""
    import warnings
    import torch
    from repro_torch.kernels import tlm_loop as TL
    invoke, mark = TL._invoke, "tlm_loop kernel launched"

    def marked(*args, **kw):
        out = invoke(*args, **kw)
        warnings.warn(mark)
        return out
    torch.cuda.synchronize()
    TL._invoke = marked
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            TL._invoke = invoke
    return out, ["launch" if str(r.message) == mark
                 else f"{Path(r.filename).name}:{r.lineno}" for r in rec
                 if str(r.message) == mark
                 or "synchronizing" in str(r.message)]


def phase_syncs(events: int, lines):
    """Host syncs of the host event loop at the paper point (phase
    profile's profiled run, sim_len PROFILE_CUT_SIM_LEN) under torch's
    sync debug mode, which warns at every call that waits for the card,
    held against the lint's static guard (:func:`_lint_guard`); then one
    covered ``lanes.simulate_lanes`` call (fig3a's k=16 group at
    SWEEP_SIM_LEN, 12 lanes) under the same mode: one ``tlm_loop``
    launch, a few set-up syncs before it, and after it only the status
    read that ends the run (``tlm_loop._check_status``), so no
    device->host read inside the run.  Returns that call's launches."""
    from repro_torch.core import lanes as LN
    read_line, per_read = lines.most_common(1)[0]
    others = sum(lines.values()) - per_read
    # one read per iteration, the last one seeing the empty queue
    if per_read != events + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"host syncs per line {dict(lines)} for "
                             f"{events} events")
    n_path, outside = _lint_guard(lines)
    p, kn, arr, gmn, lens, sim_len = _tlm_lanes("fig3a_k16")
    st, seq = _sync_sequence(lambda: LN.simulate_lanes(
        p.shape, kn, arr, gmn, lens, sim_len, p.policy, p.topo))
    n_launch = seq.count("launch")
    cut = seq.index("launch") if n_launch else len(seq)
    setup, after = seq[:cut], seq[cut + 1:]
    status_lines = _status_read_lines()
    covered = {"group": "fig3a_k16", "lanes": int(arr.shape[0]),
               "sim_len": sim_len,
               "events": int(st["events_processed"].sum()),
               "launches": n_launch, "setup_syncs": len(setup),
               "setup_by_line": dict(Counter(setup)),
               "syncs_after_launch": after}
    if n_launch != 1 or len(setup) > SETUP_SYNCS_MAX or not after \
            or any(ln not in status_lines for ln in after):
        raise AssertionError(f"syncs: the covered run's syncs {covered}; "
                             f"want one launch, at most {SETUP_SYNCS_MAX} "
                             f"set-up syncs and then only the status read "
                             f"({sorted(status_lines)})")
    emit({"phase": "syncs", "loop": "host", "sim_len": PROFILE_CUT_SIM_LEN,
          "events": events,
          "packed_read": read_line, "packed_reads": per_read,
          "other_syncs": others, "by_line": dict(lines),
          "lint": {"findings": 0, "packed_read_allowed": True,
                   "loop_path_lines": n_path,
                   "other_lines_off_path": outside},
          "covered_run": covered})
    return n_launch


def _status_read_lines() -> set:
    """The ``tlm_loop.py:N`` lines of ``tlm_loop._check_status``: the one
    read of a covered run, after its launch has ended."""
    import inspect
    from repro_torch.kernels import tlm_loop as TL
    src, first = inspect.getsourcelines(TL._check_status)
    return {f"tlm_loop.py:{first + i}" for i in range(len(src))}


# --------------------------------------------------------------------------
# The design-space engine
# --------------------------------------------------------------------------

# fig3a's k=16 group at the paper's widths: 6 thresholds x 2 seeds
SWEEP_K, SWEEP_SEEDS = 16, (1, 2)
SWEEP_THRESHOLDS = (1, 2, 4, 8, 16, 32)
SWEEP_SIM_LEN = 5e4     # cut for the script's time limit (1e5 until phase 28)
SWEEP_COUNT_SIM_LEN = 5e4     # the horizon kernels and syncs are counted at


def _run_host(p, arrivals, arrival_gmns, lengths, sim_len, trace=None):
    """``sim.run`` on the card through the host loop
    (``sim.simulate_host``) whatever the program: the phases that study
    the host loop itself (``profile``, ``syncs``, ``trace``'s untraced
    side) call it, since ``sim.run`` sends the paper's program to the
    ``tlm_loop`` kernel."""
    import torch
    from repro_torch.core import sim as S

    def dev(x, dt):
        return torch.as_tensor(x, dtype=dt).to("cuda")
    return S.simulate_host(p.shape, p.knobs, dev(arrivals, torch.float32),
                           dev(arrival_gmns, torch.int32),
                           dev(lengths, torch.float32), sim_len, p.policy,
                           p.topo, None, trace)


# phase tlm_device's lane groups, each run twice as one launch of tlm_loop
# and held against the host loop on the same lanes: (params, dn_th values, seeds, pair
# periods (None: the workload's default), sim_len).  The golden grid and
# the paper point at 1e6; one group of each paper runner at the horizon
# the card ran it at before the kernel (fig3a's k=16 and k=1 groups at
# SWEEP_SIM_LEN, fig3b's k=32 group at goldens.FIG3B_CARD_SIM_LEN, Table
# 5's k=256 group at goldens.TABLE5_SIM_LEN, baseline_compare's k=16
# group at goldens.BASELINE_SIM_LEN)
_PAPER_SHAPE = dict(m=256, n_childs=100, max_apps=512, queue_cap=2048)
TLM_DEVICE_GROUPS = {
    "golden": ("grid", None, None, None, None),
    "paper_1e6": (dict(k=16, **_PAPER_SHAPE), (4,), (1,), None, 1e6),
    "fig3a_k16": (dict(k=16, **_PAPER_SHAPE), SWEEP_THRESHOLDS, (1, 2), None,
                  SWEEP_SIM_LEN),
    "fig3a_k1": (dict(k=1, **_PAPER_SHAPE), SWEEP_THRESHOLDS, (1, 2), None,
                 SWEEP_SIM_LEN),
    "fig3b_k32": (dict(k=32, **_PAPER_SHAPE), SWEEP_THRESHOLDS, (1,), None,
                  "fig3b"),
    "table5_k256": (dict(k=256, **_PAPER_SHAPE), (4,), (1, 2, 3), None,
                    "table5"),
    "baseline_k16": (dict(k=16, **_PAPER_SHAPE), (4,), (1, 2),
                     (20_000.0, 14_000.0, 10_000.0), "baseline"),
}


def _tlm_lanes(name):
    """(params, (L,) knobs, arrivals, gmns, lengths on the card, sim_len)
    of a ``TLM_DEVICE_GROUPS`` group, lane i*S + j as ``sweep`` lays out
    knob i and workload j."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimKnobs, SimParams
    params, ths, seeds, periods, sim_len = TLM_DEVICE_GROUPS[name]
    if params == "grid":
        params, ths, seeds, sim_len = (G.GRID_PARAMS, G.GRID_DN_TH,
                                       G.GRID_SEEDS, G.GRID_SIM_LEN)
    sim_len = {"fig3b": G.FIG3B_CARD_SIM_LEN, "table5": G.TABLE5_SIM_LEN,
               "baseline": G.BASELINE_SIM_LEN}.get(sim_len, sim_len)
    p = SimParams(**params)
    wls = [W.interference_batch(p, seeds=seeds, sim_len=sim_len,
                                **({} if pp is None else
                                   {"pair_period": pp}))
           for pp in (periods or (None,))]
    arr, gmn, lens = (torch.as_tensor(np.concatenate([np.asarray(w[i])
                                                      for w in wls]),
                                      dtype=dt).to("cuda")
                      for i, dt in enumerate((torch.float32, torch.int32,
                                              torch.float32)))
    kn = SW.knob_batch(dn_th=ths).to("cuda")
    b, s = kn.dn_th.shape[0], arr.shape[0]
    return (p, SimKnobs(*(v.repeat_interleave(s) for v in kn)),
            arr.repeat(b, 1), gmn.repeat(b, 1), lens.repeat(b, 1, 1),
            sim_len)


def tlm_bound_ms(st, p, arr, sim_len) -> tuple:
    """The least time the card could take for a tlm_loop launch's work on
    this run's data, from ``tlm::run_lanes``' body; the larger of the
    bytes and the operations, and which.

    Bytes: every leaf the kernel touches, read once where it reads it and
    written once where it writes it, over the memory rate: the queue
    slots the run used (at most each lane's ``evq_peak``: a push takes
    the first free slot, so slot j is written only with j + 1 events
    queued), the rows of the applications that arrive before
    ``sim_len`` (their ``lengths`` and barrier GMN read, ``app_remaining``
    read and written, ``app_arrive`` and ``app_done`` written), the
    cluster leaves (``view_t`` and ``last_bcast_t`` written only), the
    scalars, knobs and children counts.  Operations, over the f32 peak
    (integer compares counted at that rate too, as K1's bound counts
    them): each handler's f32 arithmetic, the own-first argmins over a
    view row and the stage-2 argmins and row sums over a cluster's loads;
    the remote stage-1 targets and remote forwards are counted at the
    smaller cost of the two (3 operations), as ``mgmt_msgs`` does not
    tell them apart, and the pop's scan of the queue is not counted (a
    heap would do it in log Q operations).  Exact for a run that dropped
    nothing, as at the paper point; a run with drops raises."""
    if int(st["dropped"].sum()):
        raise ValueError("tlm_bound_ms counts the events of a run that "
                         "dropped nothing")
    sh = p.shape
    k, mpk, ns, nc = sh.k, sh.mpk, sh.ns, sh.n_childs
    lanes = int(arr.shape[0])
    n_arr = int((arr < sim_len).sum())
    slots = int(st["evq_peak"].sum())
    beacons = int(st["beacons_tx"].sum())
    n_spawn, children = n_arr * ns, n_arr * nc
    n_join = children
    if int(st["events_processed"].sum()) != n_arr + n_spawn + n_join:
        raise ValueError("tlm_bound_ms: the events are not each arrival's "
                         "ARRIVE, LOCAL_SPAWNs and JOIN_EXITs")
    remote = (int(st["mgmt_msgs"].sum()) - children - n_join
              - (k - 1) * beacons)
    n_bytes = (40 * slots               # ev_time, ev_type, ev_a: r+w
               + n_arr * (4 * nc + 20)  # lengths, parent, app_*
               + lanes * (16 * k * mpk  # pe_free, loads: r+w
                          + 32 * k      # gmn_free, lbus_free, rr_ptr,
                                        # last_bcast: r+w
                          + 4 * k       # last_bcast_t: w
                          + 8 * k * k   # view: r+w
                          + 4 * k * k   # view_t: w
                          + 72          # the nine scalars: r+w
                          + 24          # knobs, dn_th: r; status: w
                          + 4 * ns))    # cnts: r
    ops = (n_arr * (6 + ns + mpk + ns * k)            # ARRIVE
           + n_spawn * (4 + mpk) + children * (7 + mpk)   # LOCAL_SPAWN
           + n_join * (8 + mpk)                       # JOIN_EXIT
           + 3 * remote + 5 * beacons)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def _launch_ms(run):
    """``(run(), device ms of each tlm_loop launch in it)``: CUDA events
    recorded on the launch's stream just before and just after each
    launch (``tlm_loop._invoke``), so the times leave out the state's
    set-up and the status read."""
    import torch
    from repro_torch.kernels import tlm_loop as TL
    invoke, spans = TL._invoke, []

    def timed_invoke(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = invoke(*args, **kw)
        end.record()
        spans.append((start, end))
        return out
    TL._invoke = timed_invoke
    try:
        out = run()
    finally:
        TL._invoke = invoke
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in spans]


def _tlm_diff(got, want) -> tuple:
    """(leaves that differ, max |got - want| over every leaf): bitwise but
    ``mgmt_latency``, which is held to rtol 1e-5 (the host loop adds a
    handler's latencies as one vector sum)."""
    import torch
    bad, err = [], 0.0
    if set(got) != set(want):
        return sorted(set(got) ^ set(want)), float("inf")
    for key, w in want.items():
        g = got[key]
        if g.dtype != w.dtype or g.shape != w.shape:
            bad.append(key)
            continue
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
        ok = torch.allclose(g, w, rtol=1e-5, atol=0.0) \
            if key == "mgmt_latency" else torch.equal(g, w)
        if not ok:
            bad.append(key)
    return bad, err


def phase_tlm_device():
    """The event-loop kernel (``kernels/tlm_loop``) against its plain
    version, the host loop (``lanes.simulate_lanes_host``), on the card:
    each group of ``TLM_DEVICE_GROUPS`` through ``lanes.simulate_lanes``
    twice (the dispatch's path, one launch a run: the first also pays the
    allocator's and the library's first use, the second is the warm one
    reported) and the host loop on the same lanes, every leaf bit for bit
    but ``mgmt_latency`` (rtol 1e-5), the golden grid, the paper point
    and Table 5's k=256 group also against the reference's frozen
    digests.  Each group's launches (two), events, the longest lane's
    events, the launch's device time (CUDA events around it), the call's
    wall, events/s of both loops, and µs an event of the longest lane
    (the kernel's serial chain).  Returns the ``kernels`` line's numbers
    (the paper point's group)."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import lanes as LN
    from repro_torch.kernels import tlm_loop as TL
    t_phase, rows, bad, err = time.perf_counter(), {}, [], 0.0
    kernel_row = None
    for name in TLM_DEVICE_GROUPS:
        p, kn, arr, gmn, lens, sim_len = _tlm_lanes(name)
        args = (p.shape, kn, arr, gmn, lens, sim_len, p.policy, p.topo)
        torch.cuda.synchronize()
        before = TL.launches
        t0 = time.perf_counter()
        st, first_ms = _launch_ms(lambda: LN.simulate_lanes(*args))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, warm_ms = _launch_ms(lambda: LN.simulate_lanes(*args))
        wall = time.perf_counter() - t0
        n = TL.launches - before
        t0 = time.perf_counter()
        host = LN.simulate_lanes_host(*args)
        torch.cuda.synchronize()
        wall_h = time.perf_counter() - t0
        diff, e = _tlm_diff(st, host)
        err = max(err, e)
        ev = int(st["events_processed"].sum())
        longest = int(st["events_processed"].max())
        if n != 2 or len(first_ms) != 1 or len(warm_ms) != 1 or diff:
            bad.append((name, "launches", n, "leaves", diff))
        dev_ms = warm_ms[0] if warm_ms else float("nan")
        digest = None
        if name == "golden":
            shape = (len(G.GRID_DN_TH), len(G.GRID_SEEDS))
            digest = [st["beacons_tx"].reshape(shape).tolist(),
                      G.sha256_f32(st["app_done"].reshape(shape + (-1,)))] \
                == [G.GRID_BEACONS, G.GRID_APP_DONE_SHA]
        elif name == "paper_1e6":
            digest = G.paper_point_digest({k: v[0] for k, v in st.items()}) \
                == G.PAPER_POINT[sim_len]
            bound, bound_by = tlm_bound_ms(st, p, arr, sim_len)
            kernel_row = {"ms": dev_ms, "wall_ms": wall * 1e3,
                          "plain_ms": wall_h * 1e3,
                          "bound_ms": bound, "bound_by": bound_by,
                          "library_ms": None,
                          "events": ev, "us_per_event": dev_ms * 1e3 / ev,
                          "plain_us_per_event": wall_h * 1e6 / ev}
        elif name == "table5_k256":
            want = G.TABLE5[256]
            digest = [st["beacons_tx"].tolist(),
                      st["events_processed"].tolist(),
                      G.sha256_f32(st["app_done"])] == [
                want["beacons_tx"], want["events_processed"],
                want["app_done_sha"]]
        if digest is False:
            bad.append((name, "digest"))
        rows[name] = {"k": p.k, "lanes": int(arr.shape[0]),
                      "sim_len": sim_len, "launches": n, "events": ev,
                      "longest_lane_events": longest,
                      "device_ms": dev_ms, "first_device_ms": first_ms,
                      "wall_s": wall, "first_wall_s": first,
                      "events_per_s": ev / wall,
                      "device_events_per_s": ev * 1e3 / dev_ms,
                      "us_per_event_longest_lane": dev_ms * 1e3 / longest,
                      "host_wall_s": wall_h, "host_events_per_s": ev / wall_h,
                      "kernel_over_host": wall_h / wall,
                      "leaves_equal": not diff, "digest": digest}
    kernel_row["max_abs_err"] = err
    wall = time.perf_counter() - t_phase
    emit({"phase": "tlm_device", "ok": not bad, "failed": repr(bad),
          "groups": rows, "max_abs_err": err,
          "launches": sum(r["launches"] for r in rows.values()),
          "paper_point": kernel_row, "wall_s": wall})
    if bad:
        raise AssertionError(f"tlm_device: gates failed {bad}")
    return kernel_row


def _device_kernels(run):
    """``(run(), device kernels, device busy ns)`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    recs = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and e.name() not in STEP_SPANS]
    return out, len(recs), sum(recs)


def _same_leaves(got: dict, want: dict) -> bool:
    """Every leaf equal; ``mgmt_latency`` within rtol 1e-5 (its f32 sums
    may be taken in another order)."""
    import torch
    return set(got) == set(want) and all(
        torch.allclose(got[k], want[k], rtol=1e-5) if k == "mgmt_latency"
        else torch.equal(got[k], want[k]) for k in want)


def phase_sweep() -> dict:
    """The sweep engine and the paper runners on the card, all sweeps in
    "vmap" mode: every group here is the paper's program, so each runs
    as one ``tlm_loop`` launch (``"seq"``: one a lane); the kernels and
    syncs a step are counted on the host loop.  Returns the golden
    grid's vmap state (phase ``suite`` holds ``pmap`` against it)."""
    import torch
    from repro_torch.benchmarks import table5
    from repro_torch.core import goldens as G
    from repro_torch.core import lanes as LN
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimKnobs, SimParams
    t_phase, walls = time.perf_counter(), {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    # the golden grid and its single-app anchor
    p = SimParams(**G.GRID_PARAMS)
    st, one = timed("golden", lambda: (
        SW.sweep(p.shape, SW.knob_batch(dn_th=G.GRID_DN_TH),
                 W.interference_batch(p, seeds=G.GRID_SEEDS,
                                      sim_len=G.GRID_SIM_LEN),
                 G.GRID_SIM_LEN, mode="vmap"),
        SW.sweep(p.shape, SW.knob_batch(), W.independent_batch(p, n_apps=1),
                 1e7, mode="vmap")))
    got = [st["beacons_tx"].tolist(), G.sha256_f32(st["app_done"]),
           float(one["app_done"][0, 0, 0]), int(one["beacons_tx"][0, 0])]
    want = [G.GRID_BEACONS, G.GRID_APP_DONE_SHA, G.SINGLE_APP_DONE,
            G.SINGLE_APP_BEACONS]
    if got != want:
        raise AssertionError(f"sweep: golden grid {got} != {want}")
    golden = st
    # the fig3b spot grid
    p = SimParams(**G.FIG3B_PARAMS)
    st = timed("fig3b_spot", lambda: SW.sweep(
        p.shape, SW.knob_batch(dn_th=G.FIG3B_DN_TH),
        W.interference_batch(p, seeds=(G.FIG3B_SEED,),
                             sim_len=G.FIG3B_CARD_SIM_LEN),
        G.FIG3B_CARD_SIM_LEN, mode="vmap"))
    got = [st["beacons_tx"].tolist(), G.sha256_f32(st["app_done"])]
    if got != [G.FIG3B_CARD_BEACONS, G.FIG3B_CARD_APP_DONE_SHA]:
        raise AssertionError(f"sweep: fig3b spot grid {got}")
    fig3b_steps = int(st["events_processed"].max())
    # Table 5 at the paper's widths, cut to sim_len 1e5 (goldens.TABLE5_SIM_LEN)
    frame = timed("table5", lambda: table5.spec(
        G.TABLE5_SIM_LEN, G.TABLE5_SEEDS).run(mode="vmap"))
    digest = G.table5_digest(frame)
    if frame.mode != "vmap" or digest != G.TABLE5:
        raise AssertionError(f"sweep: table5 ({frame.mode}) {digest} != "
                             f"the reference's {G.TABLE5}")
    t5 = table5.payload_of(frame)
    # fig3a's k=16 group: the lane loop against per-lane runs
    p = SimParams(m=256, k=SWEEP_K, n_childs=100, max_apps=512,
                  queue_cap=2048)
    kn = SW.knob_batch(dn_th=SWEEP_THRESHOLDS)
    wl = W.interference_batch(p, seeds=SWEEP_SEEDS, sim_len=SWEEP_SIM_LEN)
    st_v = timed("lanes_vmap", lambda: SW.sweep(p.shape, kn, wl,
                                                SWEEP_SIM_LEN, mode="vmap"))
    # knob 0 over both seeds: lanes (0, 0) and (0, 1) of the grid
    st_s = timed("lanes_seq", lambda: SW.sweep(
        p.shape, SW.knob_batch(dn_th=SWEEP_THRESHOLDS[:1]), wl,
        SWEEP_SIM_LEN, mode="seq"))
    if not _same_leaves({k: v[0] for k, v in st_s.items()},
                        {k: v[0] for k, v in st_v.items()}):
        raise AssertionError("sweep: seq lanes differ from the vmap grid")
    ev_v = int(st_v["events_processed"].sum())
    ev_s = int(st_s["events_processed"].sum())
    wl_c = W.interference_batch(p, seeds=SWEEP_SEEDS,
                                sim_len=SWEEP_COUNT_SIM_LEN)
    # the count studies the host loop (``lanes.simulate_lanes_host``, the
    # tlm_loop kernel's plain version): the sweep sends this group to the
    # kernel, which has no lane steps
    arr_c, gmn_c, lens_c = (torch.as_tensor(np.asarray(x), dtype=dt)
                            .to("cuda") for x, dt in zip(
                                wl_c, (torch.float32, torch.int32,
                                       torch.float32)))
    kn_c = SimKnobs(*(v.to("cuda").repeat_interleave(arr_c.shape[0])
                      for v in kn))
    n_k = kn.dn_th.shape[0]

    def count_run():
        return LN.simulate_lanes_host(
            p.shape, kn_c, arr_c.repeat(n_k, 1), gmn_c.repeat(n_k, 1),
            lens_c.repeat(n_k, 1, 1), SWEEP_COUNT_SIM_LEN, p.policy, p.topo)
    (st_c, n_kernels, busy_ns), lines = _sync_lines(
        lambda: _device_kernels(count_run))
    steps_c = int(st_c["events_processed"].max())
    read_line, reads = lines.most_common(1)[0]
    others = sum(lines.values()) - reads
    # one read per step, the last one seeing every lane done
    if reads != steps_c + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"sweep: host syncs per line {dict(lines)} "
                             f"for {steps_c} steps")
    emit({"phase": "sweep", "mode": "vmap", "loop": "tlm_loop",
          "count_loop": "host", "golden_match": True,
          "fig3b_spot_match": True, "fig3b_spot_steps": fig3b_steps,
          "table5": {"sim_len": G.TABLE5_SIM_LEN, "digests_match": True,
                     "events_per_lane": {k: v["events_processed"]
                                         for k, v in digest.items()},
                     "group_walls_s": [g.wall_s for g in frame.groups],
                     "speedup": {k: r["speedup"]
                                 for k, r in t5["rows"].items()},
                     "ordering_clustered_best":
                         t5["ordering_clustered_best"],
                     "ratio_k16_over_k1": t5["ratio_k16_over_k1"]["ours"],
                     "paper_ratio_k16_over_k1":
                         t5["ratio_k16_over_k1"]["paper"]},
          "lanes": {"k": SWEEP_K, "sim_len": SWEEP_SIM_LEN,
                    "lanes": len(SWEEP_THRESHOLDS) * len(SWEEP_SEEDS),
                    "events": ev_v,
                    "steps": int(st_v["events_processed"].max()),
                    "vmap_events_per_s": ev_v / walls["lanes_vmap"],
                    "seq_lanes": len(SWEEP_SEEDS), "seq_events": ev_s,
                    "seq_events_per_s": ev_s / walls["lanes_seq"],
                    "vmap_over_seq": (ev_v / walls["lanes_vmap"])
                    / (ev_s / walls["lanes_seq"]),
                    "count_sim_len": SWEEP_COUNT_SIM_LEN,
                    "count_steps": steps_c,
                    "kernels_per_step": n_kernels / (steps_c + 1),
                    "device_busy_us_per_step": busy_ns / 1e3 / (steps_c + 1),
                    "packed_read": read_line,
                    "reads_per_step": reads / (steps_c + 1),
                    "other_syncs": others},
          "walls_s": walls, "wall_s": time.perf_counter() - t_phase})
    return golden


# --------------------------------------------------------------------------
# The management fabrics
# --------------------------------------------------------------------------

FABRIC_BUDGET_S = 150.0        # the phase's share of TIME_LIMIT_S
# the k=16 hier_tree probe: 5e4 (1e5 until the script took in phases
# replay, lm_train_remat, lm_train_accum and lm_resume) keeps the script
# under TIME_LIMIT_S on slow hosts (phase faults runs at 5e4, phase
# queues' k=16 and k=32 runs at 2.5e4); at 5e4 every group this phase
# runs keeps its own digest (tests/test_torch_goldens.py)
FABRIC_PROBE_SIM_LEN = 5e4
FABRIC_CUT_SIM_LEN = 5e4       # the other runs where 1e6 does not fit
FABRIC_COUNT_SIM_LEN = 2e4     # the horizon kernels per step are split at
# the groups run here (the script's time limit leaves no room for the
# rest of FABRICS: mesh2d at k=16 and k=32, and hier_tree at k=32, run
# in phase queues on the tree queue with batch_pop 64, against the same
# digests; the ideal fabric is the paper point's, phases paper and sweep)
FABRIC_GROUPS = ((16, "shared_bus"), (16, "hier_tree"), (32, "shared_bus"))
FABRIC_SEQ_K = 16              # seq runs seed 1 of these fabrics at this k
FABRIC_SEQ_TOPOLOGIES = ("shared_bus", "hier_tree", "mesh2d")
STEP_SPANS = ("lanes.step_rx", "lanes.step")   # core/lanes.py's spans


def _fabric_spec(ks, topologies, sim_len):
    """The paper tier of ``topology_frontier`` (linear queue) at
    ``sim_len``: the given k's and fabrics, seeds (1, 2), vmap mode."""
    from repro_torch.core import goldens as G
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.sim import SimParams
    return ExperimentSpec(
        shapes=tuple(SimParams(k=k, **G.FABRIC_PARAMS).shape for k in ks),
        topologies=tuple(topologies), knobs=G.FABRIC_KNOBS,
        workloads=(WorkloadSpec.make(
            "interference", seeds=G.FABRIC_SEEDS,
            pair_periods=(G.FABRIC_PAIR_PERIOD,)),),
        sim_len=sim_len, mode="vmap")


# a count's profile: skip 50 lane steps, record the next 200
COUNT_WINDOW = (50, 200)


class _WindowEnd(Exception):
    """Ends a counted run at its window's last step (the steps after it
    are not counted: the run stops there, cut in depth)."""


def _step_profile(run, skip=0, steps=None):
    """``(run() or None, by step kind, device events before the first
    step, whether the run was cut)`` under ``torch.profiler`` (host and
    card), recording lane steps ``skip + 1`` to ``skip + steps`` (to the
    end with None), where the run stops (``run()`` is then not
    returned): each device event goes to the step whose span
    (``core/lanes.py``) starts last before it; a step's window holds its
    handlers and the next step's pop and read (but the last recorded
    step's)."""
    import bisect
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import lanes
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    step, done, on = lanes._step, [0], [False]

    def windowed(*args, **kw):
        if done[0] == skip:
            torch.cuda.synchronize()
            prof.start()
            on[0] = True
        out = step(*args, **kw)
        done[0] += 1
        if on[0] and steps is not None and done[0] == skip + steps + 1:
            torch.cuda.synchronize()
            prof.stop()
            on[0] = False
            raise _WindowEnd
        return out
    lanes._step = windowed
    cut = False
    try:
        out = run()
        torch.cuda.synchronize()
    except _WindowEnd:
        out, cut = None, True
    finally:
        lanes._step = step
        if on[0]:
            prof.stop()
    evs = list(prof.profiler.kineto_results.events())
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.name()) for e in evs
                   if e.device_type() == cpu and e.name() in STEP_SPANS)
    starts = [s0 for s0, _ in spans]
    by = {n: {"steps": 0, "kernels": 0, "busy_ns": 0} for n in STEP_SPANS}
    for _, n in spans:
        by[n]["steps"] += 1
    before = 0
    for e in evs:
        if e.device_type() != cuda or e.name() in STEP_SPANS:
            continue              # the spans' own device-side annotations
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        if i < 0:
            before += 1
            continue
        by[spans[i][1]]["kernels"] += 1
        by[spans[i][1]]["busy_ns"] += e.duration_ns()
    return out, by, before, cut


def _count(run, phase: str, window=COUNT_WINDOW) -> dict:
    """Steps, kernels, device busy time and host reads a step of ``run``
    (one lane loop): one run under torch's sync debug mode, to the last
    lane step of ``window`` (skip, steps: 51-250 by default), those
    steps under ``torch.profiler`` (:func:`_step_profile`), split by
    step kind.  No busy share: the profiler's own host cost stretches
    the window's wall time.  Fails unless every step reads the card
    once."""
    with _Steps() as steps:
        (_, by, before, cut), lines = _sync_lines(
            lambda: _step_profile(run, *window))
    n = steps.n
    read_line, reads = lines.most_common(1)[0]
    others = sum(lines.values()) - reads
    # one read a step, and where the run ended by itself one more, the
    # last seeing every lane done
    if reads != n + (not cut) or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"{phase}: host syncs per line {dict(lines)} "
                             f"for {n} steps")
    profiled = sum(b["steps"] for b in by.values())
    busy_us = sum(b["busy_ns"] for b in by.values()) / 1e3 / max(profiled, 1)
    kernels = sum(b["kernels"] for b in by.values()) / max(profiled, 1)
    return {"steps": n, "cut_at_window_end": cut, "window": list(window),
            "profiled_steps": profiled,
            "kernels_per_step": kernels,
            "events_before_steps": before,
            "by_step_kind": {nm.split(".")[1]: {
                "steps": b["steps"],
                "kernels_per_step": b["kernels"] / max(b["steps"], 1),
                "device_busy_us_per_step":
                    b["busy_ns"] / 1e3 / max(b["steps"], 1)}
                for nm, b in by.items()},
            "device_busy_us_per_step": busy_us,
            "packed_read": read_line,
            "reads_per_step": reads / (n + (not cut)),
            "other_syncs": others}


def phase_fabrics():
    """The fabrics through the lane loop (and seq runs through the
    single loop) at the paper tier of ``topology_frontier``, against the
    JAX reference's frozen digests, with beacon conservation and skew
    gates, seq runs held against their vmap lanes, and kernels per step
    split by step kind."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    t_phase = time.perf_counter()

    # probe: the k=16 hier_tree group at 5e4; its rate a step predicts
    # the phase at 1e6 (steps: each group's longest lane, from the frozen
    # digests; a seq event counted as one step), else the other groups
    # and the seq runs take the cut horizon
    probe = _fabric_spec((16,), ("hier_tree",), FABRIC_PROBE_SIM_LEN) \
        .run(mode="vmap")
    probe_steps = int(np.asarray(probe.groups[0].state[
        "events_processed"]).max())
    s_per_step = probe.groups[0].wall_s / probe_steps
    full = G.FABRICS[1e6]
    work = sum(max(full[k][t]["events_processed"]) for k, t in FABRIC_GROUPS) \
        + sum(full[FABRIC_SEQ_K][t]["events_processed"][0]
              for t in FABRIC_SEQ_TOPOLOGIES)
    predicted_s = s_per_step * work
    spent = time.perf_counter() - t_phase
    sim_len = 1e6 if predicted_s <= FABRIC_BUDGET_S - spent \
        else FABRIC_CUT_SIM_LEN
    runs = [(FABRIC_PROBE_SIM_LEN, probe.groups[0])]    # (sim_len, group)
    for k in sorted({k for k, _ in FABRIC_GROUPS}):
        topos = [t for kt, t in FABRIC_GROUPS if kt == k
                 and (sim_len == 1e6 or (kt, t) != (16, "hier_tree"))]
        runs += [(sim_len, g) for g in
                 _fabric_spec((k,), topos, sim_len).run(mode="vmap").groups]

    bad = []
    for sl, g in runs:
        k, topo, st = g.combo.shape.k, g.combo.topology.kind, g.state
        got_r, want_r = G.state_digest(st), G.FABRICS[sl][k][topo]
        for key, w in want_r.items():
            ok = np.allclose(got_r[key], w, rtol=1e-5) \
                if key == "mgmt_latency" else got_r[key] == w
            if not ok:
                bad.append((sl, k, topo, key, got_r[key], w))
        tx = np.asarray(st["beacons_tx"]).ravel()
        rx = np.asarray(st["beacons_rx"]).ravel()
        drop = np.asarray(st["dropped"]).ravel()
        peak = np.asarray(st["evq_peak"]).ravel()
        skew = np.asarray(st["bcn_skew_max"]).ravel()
        empty = (np.asarray(st["bcn_t"]) >= 1e17) \
            .reshape(len(tx), -1).all(1)
        # exact where nothing dropped; an overflowing lane's missing
        # deliveries are among its dropped events
        held = (drop == 0) & (rx == (k - 1) * tx) & empty
        over = (drop > 0) & (peak == G.FABRIC_PARAMS["queue_cap"]) \
            & (rx < (k - 1) * tx) & ((k - 1) * tx <= rx + drop)
        if not ((held | over).all() and (skew > 0).all()):
            bad.append((sl, k, topo, "transport gates", tx.tolist(),
                        rx.tolist(), drop.tolist(), skew.tolist(),
                        empty.tolist()))
    if bad:
        raise AssertionError(f"fabrics: gates failed {bad}")

    # seq: seed 1 of each k=16 fabric off ideal, against its vmap lane
    # where this phase ran the fabric's group at the same horizon, and
    # against the frozen digest's counters of its lane
    p = SimParams(k=FABRIC_SEQ_K, **G.FABRIC_PARAMS)
    kn = SW.knob_batch(**G.FABRIC_KNOBS)
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS[:1], sim_len=sim_len,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    vmap_at = {(g.combo.shape.k, g.combo.topology.kind): g.state
               for sl, g in runs if sl == sim_len}
    seq = {}
    for topo in FABRIC_SEQ_TOPOLOGIES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = SW.sweep(p.shape, kn, wl, sim_len, mode="seq", topology=topo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (FABRIC_SEQ_K, topo) in vmap_at:
            lane = {key: v[0, 0]
                    for key, v in vmap_at[FABRIC_SEQ_K, topo].items()}
            if set(st) != set(lane) or not all(
                    np.allclose(st[key][0, 0].cpu().numpy(), lane[key],
                                rtol=1e-5) if key == "mgmt_latency"
                    else np.array_equal(st[key][0, 0].cpu().numpy(),
                                        lane[key])
                    for key in lane):
                raise AssertionError(f"fabrics: seq {topo} differs from "
                                     "its vmap lane")
        got = G.state_digest({key: v.cpu().numpy() for key, v in st.items()})
        for key, w in G.FABRICS[sim_len][FABRIC_SEQ_K][topo].items():
            if key == "app_done_sha":     # the digest's sha covers 2 lanes
                continue
            if not (np.allclose(got[key], w[:1], rtol=1e-5)
                    if key == "mgmt_latency" else got[key] == w[:1]):
                raise AssertionError(f"fabrics: seq {topo} {key} "
                                     f"{got[key]} != {w[:1]}")
        ev = int(st["events_processed"].sum())
        seq[topo] = {"events": ev, "wall_s": wall, "events_per_s": ev / wall}

    # kernels and reads per step at a short horizon, by step kind
    pc = SimParams(k=16, **G.FABRIC_PARAMS)
    wl_c = W.interference_batch(pc, seeds=G.FABRIC_SEEDS,
                                sim_len=FABRIC_COUNT_SIM_LEN,
                                pair_period=G.FABRIC_PAIR_PERIOD)

    def count_run():
        return SW.sweep(pc.shape, kn, wl_c, FABRIC_COUNT_SIM_LEN,
                        mode="vmap", topology="hier_tree")
    count = _count(count_run, "fabrics")

    groups = []
    for sl, g in runs:
        k, topo = g.combo.shape.k, g.combo.topology.kind
        ev = int(np.asarray(g.state["events_processed"]).sum())
        row = {"k": k, "topology": topo, "sim_len": sl,
               "lanes": int(np.asarray(g.state["events_processed"]).size),
               "steps": int(np.asarray(g.state["events_processed"]).max()),
               "events": ev, "wall_s": g.wall_s,
               "vmap_events_per_s": ev / g.wall_s,
               "beacons_tx": np.asarray(g.state["beacons_tx"]).ravel()
               .tolist(),
               "beacons_rx": np.asarray(g.state["beacons_rx"]).ravel()
               .tolist(),
               "bcn_skew_max": np.asarray(g.state["bcn_skew_max"]).ravel()
               .tolist()}
        if k == FABRIC_SEQ_K and sl == sim_len and topo in seq:
            row["seq_events_per_s"] = seq[topo]["events_per_s"]
        groups.append(row)
    emit({"phase": "fabrics", "sim_len": sim_len, "mode": "vmap",
          "probe": {"sim_len": FABRIC_PROBE_SIM_LEN, "steps": probe_steps,
                    "wall_s": probe.groups[0].wall_s,
                    "predicted_1e6_s": predicted_s},
          "digests_match": True, "conservation": True, "skew": True,
          "overflowing_groups": [
              [sl, g.combo.shape.k, g.combo.topology.kind]
              for sl, g in runs
              if int(np.asarray(g.state["dropped"]).sum()) > 0],
          "groups": groups, "seq": seq, "seq_sim_len": sim_len,
          "count": {"k": 16, "topology": "hier_tree", "queue_impl": "linear",
                    "batch_pop": 1, "sim_len": FABRIC_COUNT_SIM_LEN,
                    **count},
          "wall_s": time.perf_counter() - t_phase})
    # the linear queue's baselines of phase queues: the probe and the count
    return {"probe": {"sim_len": FABRIC_PROBE_SIM_LEN, "steps": probe_steps,
                      "events": int(np.asarray(probe.groups[0].state[
                          "events_processed"]).sum()),
                      "wall_s": probe.groups[0].wall_s},
            "probe_state": probe.groups[0].state,
            "count": dict(count, sim_len=FABRIC_COUNT_SIM_LEN)}


# --------------------------------------------------------------------------
# The event queues and the BEACON_RX batch window
# --------------------------------------------------------------------------

QUEUE_IMPLS = ("linear", "tree", "calendar")
QUEUE_BATCH = 64                # topology_frontier's paper-tier window
QUEUE_H2H_SIM_LEN = 1e4         # the batch_pop-1 head-to-head's horizon
QUEUE_COUNT_SIM_LEN = FABRIC_COUNT_SIM_LEN   # linear/1's count is fabrics'
# The horizons are cut for the script's time limit, each to one of
# goldens.FABRICS/CUTS: k=256's to 5e4 (both fabrics at 1e5 took 69 s of
# a run; at 2.5e4 no k=256 lane sends a beacon), k=1's to 5e4 (2.5e5:
# 9 s on a slow host, 1e5: 3.3 s; phase paper_suite took the time), the
# tree queue's at k=32 to 2.5e4 (5e4: 26 s),
# the k=16 runs with batch_pop 64 and their seq run to 2.5e4 (1e5: 62 s,
# 5e4: 20 s) and the batch_pop-1 head-to-head (compared with the linear
# queue, not a digest) to 1e4 (2e4: 11 s): phase 28 took the time
QUEUE_CUT_SIM_LEN = 5e4
QUEUE_K1_SIM_LEN = 5e4
QUEUE_K32_SIM_LEN = 2.5e4
QUEUE_BATCH_SIM_LEN = 2.5e4


class _Steps:
    """Counts the event loops' iterations while open: calls of
    ``lanes._step`` (a lane step) and ``sim._commit`` (an iteration of
    the single loop); ``launches`` the ``tlm_loop`` kernel's launches
    (a run of the paper's program, which takes no host step)."""

    def __enter__(self):
        from repro_torch.core import lanes, sim
        from repro_torch.kernels import tlm_loop as TL
        self.n, self.l0, self.launches = 0, TL.launches, 0
        self._saved = [(lanes, "_step", lanes._step),
                       (sim, "_commit", sim._commit)]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        from repro_torch.kernels import tlm_loop as TL
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self.launches = TL.launches - self.l0


def _queue_group(k, topology, sim_len, queue_impl, batch_pop, mode="vmap"):
    """One group of ``topology_frontier``'s paper tier (seeds 1 and 2) at
    ``k`` on one fabric and queue, through ``ExperimentSpec`` (the cut
    points' queue sizes at k=1 and k=256): ``(state, wall_s, steps)``."""
    from repro_torch.core import goldens as G
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.sim import SimParams
    params = G.cut_params(k) if k in G.CUT_KS else G.FABRIC_PARAMS
    params = dict(params, queue_impl=queue_impl, batch_pop=batch_pop)
    spec = ExperimentSpec(
        shapes=(SimParams(k=k, **params).shape,), topologies=(topology,),
        knobs=G.FABRIC_KNOBS,
        workloads=(WorkloadSpec.make("interference", seeds=G.FABRIC_SEEDS,
                                     pair_periods=(G.FABRIC_PAIR_PERIOD,)),),
        sim_len=sim_len, mode=mode)
    with _Steps() as steps:
        frame = spec.run()
    return (frame.groups[0].state, frame.groups[0].wall_s, steps.n,
            steps.launches)


def _queue_row(k, topology, sim_len, queue_impl, batch_pop, run):
    """The printed record of one run ``(state, wall_s, steps,
    launches)``: the lane loop's steps (0 where the run is one
    ``tlm_loop`` launch: k=1 on ``ideal``), events and events/s."""
    st, wall, steps, launches = run
    ev = np.asarray(st["events_processed"])
    return {"k": k, "topology": topology, "queue_impl": queue_impl,
            "batch_pop": batch_pop, "sim_len": sim_len,
            "lanes": int(ev.size), "steps": steps,
            "tlm_loop_launches": launches, "events": int(ev.sum()),
            "wall_s": wall, "events_per_s": int(ev.sum()) / wall}


def _queue_gates(st, k, topology):
    """Beacon conservation on drop-free lanes and an empty ``bcn_t``."""
    tx = np.asarray(st["beacons_tx"]).ravel()
    rx = np.asarray(st["beacons_rx"]).ravel()
    drop = np.asarray(st["dropped"]).ravel()
    empty = (np.asarray(st["bcn_t"]) >= 1e17).all()
    if topology == "ideal" or k == 1:
        return bool((rx == 0).all() and empty)
    return bool(((drop > 0) | (rx == (k - 1) * tx)).all() and empty)


def _queue_count(k, topology, queue_impl, batch_pop):
    """:func:`_count` of one combo at ``QUEUE_COUNT_SIM_LEN``."""
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    p = SimParams(k=k, **dict(G.FABRIC_PARAMS, queue_impl=queue_impl,
                              batch_pop=batch_pop))
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS,
                              sim_len=QUEUE_COUNT_SIM_LEN,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    kn = SW.knob_batch(**G.FABRIC_KNOBS)
    return dict(_count(lambda: SW.sweep(
        p.shape, kn, wl, QUEUE_COUNT_SIM_LEN, mode="vmap",
        topology=topology), "queues"),
        sim_len=QUEUE_COUNT_SIM_LEN)


def phase_queues(linear):
    """The tree and calendar queues and the BEACON_RX batch window
    (``batch_pop``) through the lane loop at ``topology_frontier``'s
    paper tier: every queue equal to the linear one bit for bit, the
    frozen reference digests of the tier and of its two cut points (k=1,
    k=256), a seq run equal to its vmap lane, and each k=16 combo's
    steps, events/s, kernels, busy time and reads a step.
    ``linear["probe"]`` is phase ``fabrics``' k=16 ``hier_tree`` linear
    run at 5e4, the baseline of the events/s ratios, and its count of
    linear/1 (``linear``: ``probe`` and ``count``)."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams
    t_phase = time.perf_counter()
    rows, bad = [], []
    queue_keys = {"evq_tree", "evq_cal", "evq_root", "ev_time", "ev_type",
                  "ev_a"}

    def check(name, got, want):
        for key, w in want.items():
            ok = np.allclose(got[key], w, rtol=1e-5) \
                if key == "mgmt_latency" else got[key] == w
            if not ok:
                bad.append((name, key, got[key], w))

    # the head-to-head at k=16 on hier_tree: batch_pop 1 at 1e4 against
    # the linear queue leaf for leaf (every leaf but the queue's own)
    k, topo = 16, "hier_tree"
    base = None
    for qi in QUEUE_IMPLS:
        run = _queue_group(k, topo, QUEUE_H2H_SIM_LEN, qi, 1)
        rows.append(_queue_row(k, topo, QUEUE_H2H_SIM_LEN, qi, 1, run))
        st = run[0]
        leaves = {key: v for key, v in st.items() if key not in queue_keys}
        if base is None:
            base = leaves
        elif set(leaves) != set(base) or not all(
                np.array_equal(leaves[key], base[key]) for key in base):
            bad.append((qi, 1, "differs from linear/1"))
    # ... and batch_pop 64 at 2.5e4 against the reference's digests
    want = G.FABRICS[QUEUE_BATCH_SIM_LEN]
    states = {}
    for qi in QUEUE_IMPLS:
        run = _queue_group(k, topo, QUEUE_BATCH_SIM_LEN, qi, QUEUE_BATCH)
        st = states[qi] = run[0]
        rows.append(_queue_row(k, topo, QUEUE_BATCH_SIM_LEN, qi,
                               QUEUE_BATCH, run))
        check((k, topo, qi), G.state_digest(st), want[k][topo])
        if not _queue_gates(st, k, topo):
            bad.append((k, topo, qi, "transport gates"))
    # the tree queue at k=32 on two fabrics
    for topo32 in ("hier_tree", "mesh2d"):
        run = _queue_group(32, topo32, QUEUE_K32_SIM_LEN, "tree",
                           QUEUE_BATCH)
        st = run[0]
        rows.append(_queue_row(32, topo32, QUEUE_K32_SIM_LEN, "tree",
                               QUEUE_BATCH, run))
        check((32, topo32), G.state_digest(st),
              G.FABRICS[QUEUE_K32_SIM_LEN][32][topo32])
        if not _queue_gates(st, 32, topo32):
            bad.append((32, topo32, "transport gates"))

    # seq on seed 1 of the k=16 tree/64 combo, against its vmap lane
    p = SimParams(k=k, **dict(G.FABRIC_PARAMS, queue_impl="tree",
                              batch_pop=QUEUE_BATCH))
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS[:1],
                              sim_len=QUEUE_BATCH_SIM_LEN,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Steps() as steps:
        st = SW.sweep(p.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl,
                      QUEUE_BATCH_SIM_LEN, mode="seq", topology=topo)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lane = {key: v[0, 0] for key, v in states["tree"].items()}
    if set(st) != set(lane) or not all(
            np.allclose(st[key][0, 0].cpu().numpy(), lane[key], rtol=1e-5)
            if key == "mgmt_latency"
            else np.array_equal(st[key][0, 0].cpu().numpy(), lane[key])
            for key in lane):
        bad.append(("seq", "tree", QUEUE_BATCH, "differs from vmap lane"))
    ev = int(st["events_processed"].sum())
    seq = {"k": k, "topology": topo, "queue_impl": "tree",
           "batch_pop": QUEUE_BATCH, "sim_len": QUEUE_BATCH_SIM_LEN,
           "seed": G.FABRIC_SEEDS[0], "iterations": steps.n, "events": ev,
           "wall_s": wall, "events_per_s": ev / wall}

    # kernels, busy time and reads a step of every k=16 combo
    counts = {f"{qi}/{bp}": linear["count"] if (qi, bp) == ("linear", 1)
              else _queue_count(k, topo, qi, bp)
              for bp in (1, QUEUE_BATCH) for qi in QUEUE_IMPLS}

    # the cut points: k=1 and k=256 at 5e4 (k=1 on its golden's
    # linear queue: one cluster sends no beacon, so no queue or batch
    # window changes a bit)
    cuts = G.CUTS
    q1 = (G.CUT_QUEUES[1]["queue_impl"], G.CUT_QUEUES[1]["batch_pop"])
    run = _queue_group(1, "ideal", QUEUE_K1_SIM_LEN, *q1)
    st = run[0]
    rows.append(_queue_row(1, "ideal", QUEUE_K1_SIM_LEN, *q1, run))
    check((1, "ideal"), G.state_digest(st),
          cuts[QUEUE_K1_SIM_LEN][1]["ideal"])
    if not _queue_gates(st, 1, "ideal"):
        bad.append((1, "transport gates"))
    for topo256 in G.CUT_TOPOLOGIES[256]:
        run = _queue_group(256, topo256, QUEUE_CUT_SIM_LEN, "tree",
                           QUEUE_BATCH)
        st = run[0]
        rows.append(_queue_row(256, topo256, QUEUE_CUT_SIM_LEN, "tree",
                               QUEUE_BATCH, run))
        check((256, topo256), G.state_digest(st),
              cuts[QUEUE_CUT_SIM_LEN][256][topo256])
        if not _queue_gates(st, 256, topo256):
            bad.append((256, topo256, "transport gates"))
    if bad:
        raise AssertionError(f"queues: gates failed {bad}")
    lin = linear["probe"]["events"] / linear["probe"]["wall_s"]
    for r in rows:
        if (r["k"], r["topology"], r["sim_len"]) == (
                k, topo, QUEUE_BATCH_SIM_LEN):
            # against the probe's linear/1 run at its own 5e4
            r["events_per_s_over_linear_1"] = r["events_per_s"] / lin
    emit({"phase": "queues", "mode": "vmap", "digests_match": True,
          "bitwise_across_queues": True, "conservation": True,
          "seq_equals_vmap": True,
          "linear_1_baseline": dict(linear["probe"], events_per_s=lin,
                                    source="phase fabrics' probe"),
          "runs": rows, "seq": seq, "count": counts,
          "wall_s": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------
# Fault injection and the failure detector
# --------------------------------------------------------------------------

FAULT_COUNT_SIM_LEN = 2e4       # the horizon kernels per step are split at
# the no-fault group's window is phase fabrics' (steps 51-250); the
# outage group's lies inside its outage (0.3-0.8 of the horizon)
FAULT_OUTAGE_WINDOW = (300, 400)
FAULT_SEQ_KEY = "hier_tree/min_search/threshold/partition"
FAULT_NONE_KEY = "hier_tree/min_search/threshold/none"


def phase_faults(linear):
    """Fault injection and the failure detector through the lane loop at
    ``topology_frontier``'s paper tier (``goldens.fault_specs``): every
    group against the JAX reference's frozen digests
    (``goldens.FAULTS``), the no-fault group also against
    ``goldens.FABRICS`` and, for its cost, beside phase ``fabrics``'
    no-fault probe on the same lanes (``linear``, at the same horizon),
    conservation with
    losses and retries, completion, the partition's downtime, a seq run
    equal to its vmap lane, and kernels, busy time and reads a step."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policies import SimPolicy
    from repro_torch.core.sim import SimParams
    t_phase = time.perf_counter()
    sim_len = G.FAULT_SIM_LEN
    frames = [spec.run() for spec in G.fault_specs(
        ExperimentSpec, WorkloadSpec, SimParams, FaultSpec, mode="vmap")]
    groups = {G.fault_key(g.coords()): g for fr in frames
              for g in fr.groups}
    bad = []
    got = G.fault_digests(frames)
    if set(got) != set(G.FAULTS):
        bad.append(("groups", sorted(got), sorted(G.FAULTS)))
    for key, want in G.FAULTS.items():
        for name, w in want.items():
            if got.get(key, {}).get(name) != w:
                bad.append((key, name, got.get(key, {}).get(name), w))
    # the fault-aware program with no event is the no-fault one
    none = G.state_digest(groups[FAULT_NONE_KEY].state)
    for name, w in G.FABRICS[sim_len][G.FAULT_K]["hier_tree"].items():
        ok = np.allclose(none[name], w, rtol=1e-5) \
            if name == "mgmt_latency" else none[name] == w
        if not ok:
            bad.append(("none against FABRICS", name, none[name], w))
    k = G.FAULT_K
    cut = 2 * (k // 2) * (k - k // 2)      # the partition's directed links
    rows = []
    for key, g in groups.items():
        st = {name: np.asarray(v) for name, v in g.state.items()}
        tx, rx, lost, rtr, drop = (st[n].ravel() for n in (
            "beacons_tx", "beacons_rx", "msgs_lost", "retries_tx",
            "dropped"))
        if not ((drop > 0) | (rx + lost == (k - 1) * tx + rtr)).all():
            bad.append((key, "conservation", tx.tolist(), rx.tolist(),
                        lost.tolist(), rtr.tolist()))
        arrived = st["app_arrive"] < 1e17
        if not (st["app_done"][arrived] < 1e17).all():
            bad.append((key, "an arrived application never completed"))
        if g.fault_label == "partition" and not (
                st["downtime"] == np.float32(cut * 0.3 * sim_len)).all():
            bad.append((key, "downtime", st["downtime"].tolist()))
        ev = st["events_processed"]
        rows.append({"group": key, "lanes": int(ev.size),
                     "steps": int(ev.max()), "events": int(ev.sum()),
                     "wall_s": g.wall_s,
                     "events_per_s": int(ev.sum()) / g.wall_s,
                     "msgs_lost": lost.tolist(), "retries_tx": rtr.tolist(),
                     "reroutes": st["reroutes"].ravel().tolist(),
                     "susp_onsets": st["susp_onsets"].reshape(
                         ev.size, -1).sum(1).tolist(),
                     "susp_false_pos": st["susp_false_pos"].ravel()
                     .tolist()})

    # seq: seed 1 of the partition group through the single loop
    g = groups[FAULT_SEQ_KEY]
    p = SimParams(k=k, **G.FABRIC_PARAMS)
    wl = W.interference_batch(p, seeds=G.FABRIC_SEEDS[:1], sim_len=sim_len,
                              pair_period=G.FABRIC_PAIR_PERIOD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = SW.sweep(g.combo.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl,
                  sim_len, mode="seq", topology=g.combo.topology,
                  policy=g.combo.policy, faults=g.fault)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lane = {key: v[0, 0] for key, v in g.state.items()}
    if set(st) != set(lane) or not all(
            np.allclose(st[key][0, 0].cpu().numpy(), lane[key], rtol=1e-5)
            if key == "mgmt_latency"
            else np.array_equal(st[key][0, 0].cpu().numpy(), lane[key])
            for key in lane):
        bad.append(("seq", FAULT_SEQ_KEY, "differs from its vmap lane"))
    if bad:
        raise AssertionError(f"faults: gates failed {bad}")
    ev = int(st["events_processed"].sum())
    seq = {"group": FAULT_SEQ_KEY, "seed": G.FABRIC_SEEDS[0],
           "sim_len": sim_len, "events": ev, "wall_s": wall,
           "events_per_s": ev / wall}

    # kernels, busy time and reads a step at a short horizon: the
    # no-fault group (against phase fabrics' linear/1 count), and the
    # detector tier's outage group inside its outage
    pc = SimParams(k=k, **G.FABRIC_PARAMS)
    wl_c = W.interference_batch(pc, seeds=G.FABRIC_SEEDS,
                                sim_len=FAULT_COUNT_SIM_LEN,
                                pair_period=G.FABRIC_PAIR_PERIOD)
    sl = FAULT_COUNT_SIM_LEN
    counts = {
        "none": _count(lambda: SW.sweep(
            pc.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl_c, sl,
            mode="vmap", topology="hier_tree", faults=FaultSpec.none()),
            "faults"),
        "gmn_outage/avoid_suspected/periodic": _count(lambda: SW.sweep(
            pc.shape, SW.knob_batch(**G.DETECTOR_KNOBS), wl_c, sl,
            mode="vmap", topology="hier_tree",
            policy=SimPolicy("avoid_suspected", "periodic"),
            faults=FaultSpec.gmn_outage(t_down=0.3 * sl, t_heal=0.8 * sl)),
            "faults", FAULT_OUTAGE_WINDOW)}
    base = linear["probe"]
    none_row = next(r for r in rows if r["group"] == FAULT_NONE_KEY)
    emit({"phase": "faults", "sim_len": sim_len, "mode": "vmap",
          "k": k, "queue": "linear/1", "digests_match": True,
          "none_equals_fabrics": True, "conservation": True,
          "complete": True, "downtime": True, "seq_equals_vmap": True,
          "groups": rows, "seq": seq,
          "none_against_no_fault": {
              "no_fault_events_per_s": base["events"] / base["wall_s"],
              "no_fault_steps": base["steps"],
              "fault_aware_events_per_s": none_row["events_per_s"],
              "fault_aware_steps": none_row["steps"],
              "ratio": none_row["events_per_s"]
              / (base["events"] / base["wall_s"]),
              "no_fault_sim_len": FABRIC_PROBE_SIM_LEN,
              "fault_aware_sim_len": sim_len,
              "source": "phase fabrics' probe"},
          "count": {"sim_len": sl, **counts,
                    "no_fault_linear_1": linear["count"]},
          "wall_s": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------
# The in-loop trace
# --------------------------------------------------------------------------

TRACE_BUDGET_S = 60.0          # the phase's share of TIME_LIMIT_S
# the paper point's kernels an event and events/s, trace on and off
# (5e4 until the script took in the training configurations)
TRACE_COUNT_SIM_LEN = 2.5e4


def _trace_gates(name, on, off, spec) -> list:
    """Phase trace's gates on one run: every leaf of the untraced state
    ``off`` bitwise in the traced ``on`` (numpy or tensor leaves, any
    lane axes), the trace leaves against ``goldens.TRACE[name]``,
    every lane's conservation checks, and a valid Perfetto export of
    each lane.  Returns the failures."""
    from repro_torch.core import goldens as G
    from repro_torch.core.trace import (TraceFrame, trace_state,
                                        validate_perfetto)
    on = {key: G._host(v) for key, v in on.items()}
    off = {key: G._host(v) for key, v in off.items()}
    bad = []
    if set(on) != set(off) | set(trace_state(spec, 1, "cpu")):
        bad.append((name, "leaves", sorted(set(on) ^ set(off))))
    bad += [(name, "shared leaf", key) for key in off
            if key in on and not np.array_equal(on[key], off[key])]
    bad += [(name, "digest") + m for m in G.trace_mismatches(
        G.trace_digest(on), G.TRACE[name])]
    lead = on["tr_n"].shape
    for i in np.ndindex(lead):
        tf = TraceFrame({key: v[i] for key, v in on.items()}, spec)
        chk = tf.check()
        if not chk["ok"]:
            bad.append((name, "check", i, chk))
        errs = validate_perfetto(tf.to_perfetto())
        if errs:
            bad.append((name, "perfetto", i, errs[:3]))
    return bad


def _paper_count(trace):
    """Kernels, device busy time and host syncs an event of the paper
    point at TRACE_COUNT_SIM_LEN in the host loop, with ``trace`` or
    without."""
    p, wl = _paper_run(TRACE_COUNT_SIM_LEN)
    (st, n, busy), lines = _sync_lines(lambda: _device_kernels(
        lambda: _run_host(p, *wl, TRACE_COUNT_SIM_LEN, trace=trace)))
    events = int(st["events_processed"])
    read_line, reads = lines.most_common(1)[0]
    others = sum(lines.values()) - reads
    if reads != events + 1 or others > SETUP_SYNCS_MAX:
        raise AssertionError(f"trace: host syncs per line {dict(lines)} "
                             f"for {events} events (trace {trace})")
    return {"events": events, "kernels_per_event": n / events,
            "device_busy_us_per_event": busy / 1e3 / events,
            "reads_per_event": reads / (events + 1), "other_syncs": others}


def _in_turns(run_off, run_on) -> dict:
    """Events/s of two runs of the same events, untraced and traced,
    timed in turns (off, on, on, off; each ending in a synchronize) so
    that a drift of the host's speed falls on both."""
    import torch
    walls, events = {"off": 0.0, "on": 0.0}, 0
    for which in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = (run_on if which == "on" else run_off)()
        torch.cuda.synchronize()
        walls[which] += time.perf_counter() - t0
        events = int(st["events_processed"].sum())
    if events == 0:
        raise AssertionError("trace: a timed run processed no event")
    return {"events": events, "wall_s_off": walls["off"] / 2,
            "wall_s_on": walls["on"] / 2,
            "events_per_s_off": 2 * events / walls["off"],
            "events_per_s_on": 2 * events / walls["on"],
            "on_over_off_wall": walls["on"] / walls["off"]}


def phase_trace(paper_off, linear):
    """The in-loop trace on the card, with trace_report's TraceSpec:
    (a) the paper point through ``sim.run`` at PROFILE_CUT_SIM_LEN
    against phase ``profile``'s untraced timed run (``paper_off``; both
    in the host loop: a trace is outside the ``tlm_loop`` kernel's
    program, so the untraced side runs ``sim.simulate_host`` too);
    (b) the tier's k=16 ``hier_tree`` group (linear queue, seeds 1-2) at
    5e4 through the lane loop against phase ``fabrics``' untraced probe;
    (c) k=16 ``hier_tree`` on tree/64 under a partition at 2e4 with a
    ring that overflows, against its untraced run.  Gates
    (:func:`_trace_gates`): shared leaves bitwise, the trace leaves
    against ``goldens.TRACE``, conservation on every lane, valid
    Perfetto.  Reports events/s on and off in this call (the gated runs'
    walls, and shorter runs timed in turns), kernels, device busy time
    and syncs an event (a) or a step by kind (b) on and off, and the
    percentile columns."""
    import dataclasses
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import sweep as SW
    from repro_torch.core import workloads as W
    from repro_torch.core.experiment import ExperimentSpec, WorkloadSpec
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.sim import SimParams, run
    from repro_torch.core.trace import TraceFrame, TraceSpec
    t_phase = time.perf_counter()
    spec = TraceSpec(**G.TRACE_FIELDS)
    bad = []

    # (a) the paper point at phase profile's horizon
    if G.TRACE_SIM_LENS["paper"] != PROFILE_CUT_SIM_LEN:
        raise AssertionError("trace: the paper point's traced horizon is "
                             "not phase profile's")
    p, wl = _paper_run(G.TRACE_SIM_LENS["paper"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(p, *wl, G.TRACE_SIM_LENS["paper"], trace=spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad += _trace_gates("paper", st, paper_off["state"], spec)
    ev = int(st["events_processed"])
    tf = TraceFrame(st, spec)
    p_c, wl_c = _paper_run(TRACE_COUNT_SIM_LEN)
    paper = {"sim_len": G.TRACE_SIM_LENS["paper"], "events": ev,
             "events_per_s_on": ev / wall,
             "events_per_s_off": paper_off["events"] / paper_off["wall_s"],
             "on_over_off_wall": wall / paper_off["wall_s"],
             "wall_s_on": wall, "wall_s_off": paper_off["wall_s"],
             "mgmt": tf.percentiles("mgmt"), "resp": tf.percentiles("resp"),
             "in_turns": {"sim_len": TRACE_COUNT_SIM_LEN, **_in_turns(
                 lambda: _run_host(p_c, *wl_c, TRACE_COUNT_SIM_LEN),
                 lambda: run(p_c, *wl_c, TRACE_COUNT_SIM_LEN,
                             trace=spec))},
             "count": {"sim_len": TRACE_COUNT_SIM_LEN,
                       "off": _paper_count(None), "on": _paper_count(spec)}}

    # (b) and (c) through the lane loop, each against its untraced run
    if G.TRACE_SIM_LENS["hier_tree"] != FABRIC_PROBE_SIM_LEN:
        raise AssertionError("trace: the hier_tree group's traced horizon "
                             "is not phase fabrics' probe's")
    specs = G.trace_specs(ExperimentSpec, WorkloadSpec, SimParams,
                          FaultSpec, TraceSpec, mode="vmap")
    groups = {}
    for name, sp in specs.items():
        frame = sp.run()
        g = frame.groups[0]
        if name == "hier_tree":
            off_state, off_wall = linear["probe_state"], \
                linear["probe"]["wall_s"]
        else:
            g_off = dataclasses.replace(sp, trace=None).run().groups[0]
            off_state, off_wall = g_off.state, g_off.wall_s
        bad += _trace_gates(name, g.state, off_state, sp.trace)
        ev = np.asarray(g.state["events_processed"])
        groups[name] = {
            "sim_len": sp.sim_len, "lanes": int(ev.size),
            "steps": int(ev.max()), "events": int(ev.sum()),
            "queue": f"{g.combo.shape.queue_impl}/{g.combo.shape.batch_pop}",
            "fault": g.fault_label, "ring_cap": sp.trace.ring_cap,
            "trace_dropped": np.asarray(g.state["trace_dropped"]).ravel()
            .tolist(),
            "wall_s_on": g.wall_s, "wall_s_off": off_wall,
            "events_per_s_on": int(ev.sum()) / g.wall_s,
            "events_per_s_off": int(ev.sum()) / off_wall,
            "on_over_off_wall": g.wall_s / off_wall,
            **{c: frame.col(c).tolist() for c in frame.PCT_NAMES}}
    if bad:
        raise AssertionError(f"trace: gates failed {bad}")

    # (b)'s kernels, busy time and reads a step at 2e4, against phase
    # fabrics' untraced count of the same run
    pc = SimParams(k=16, **G.FABRIC_PARAMS)
    wl_l = W.interference_batch(pc, seeds=G.FABRIC_SEEDS,
                                sim_len=FABRIC_COUNT_SIM_LEN,
                                pair_period=G.FABRIC_PAIR_PERIOD)

    def lanes(trace):
        return SW.sweep(pc.shape, SW.knob_batch(**G.FABRIC_KNOBS), wl_l,
                        FABRIC_COUNT_SIM_LEN, mode="vmap",
                        topology="hier_tree", trace=trace)
    count = _count(lambda: lanes(spec), "trace")
    groups["hier_tree"]["in_turns"] = {
        "sim_len": FABRIC_COUNT_SIM_LEN,
        **_in_turns(lambda: lanes(None), lambda: lanes(spec))}
    wall_phase = time.perf_counter() - t_phase
    emit({"phase": "trace", "trace": spec.to_dict(), "gates": True,
          "paper": paper, "groups": groups,
          "count": {"sim_len": FABRIC_COUNT_SIM_LEN, "k": 16,
                    "topology": "hier_tree", "queue": "linear/1",
                    "on": count, "off": linear["count"]},
          "budget_s": TRACE_BUDGET_S,
          "within_budget": wall_phase <= TRACE_BUDGET_S,
          "wall_s": wall_phase})


# --------------------------------------------------------------------------
# K2, K3 and the LM serving path
# --------------------------------------------------------------------------

# the JAX tests' cases (tests/test_kernels_flash.py, test_kernels_scan.py)
K2_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window)
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 0),
    (2, 128, 128, 8, 2, 64, False, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (1, 192, 192, 2, 1, 64, True, 0),
    (1, 128, 256, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 1, 16, True, 0),     # the reduced Jamba of lm_small
    # every head dim, lengths that are not multiples of the bf16
    # kernel's 128-row q and key tiles, Sq < Skv, a window
    (2, 200, 328, 4, 2, 128, True, 0),
    (1, 130, 257, 2, 1, 16, True, 0),
    (1, 100, 200, 2, 2, 32, False, 0),
    (1, 333, 333, 2, 1, 128, True, 96),
    (1, 70, 190, 2, 2, 64, True, 0),
] + [
    # the last five families' shapes: whisper_medium's cross
    # attention (Sq > Skv, no mask) and its encoder, glm4_9b's group of 16
    # q heads over 2 kv heads, minicpm_2b's 36 heads
    (1, 2048, 1500, 16, 16, 64, False, 0),
    (1, 1500, 1500, 16, 16, 64, False, 0),
    (1, 512, 512, 32, 2, 128, True, 0),
    (1, 333, 333, 36, 36, 64, True, 0),
]
K2_MODEL = (2, 4096, 4096, 32, 8, 128, True, 0)   # Jamba's prefill shape
K3_CASES = [(2, 64, 16, 4), (1, 128, 32, 8), (2, 32, 8, 4), (1, 64, 8, 16),
            # S not a multiple of the kernel's 64-step runs, Di not one of
            # its channel blocks; rows not whole 16-byte chunks (Di=37,
            # N=5); N = 64 and N = 1
            (2, 1000, 200, 16), (1, 77, 37, 5), (1, 130, 24, 64),
            (1, 65, 40, 1)]
K3_MODEL = (2, 4096, 8192, 16)                    # (B, S, Di, N)
# K2: the reference test's tolerances (1e-4 f32; 2e-2 bf16, one rounding
# of outputs of order one).  K3: 1e-4 in f32; in bf16 the two f32 results
# may round to neighbouring bf16 values, one unit in the last place,
# <= 2**-7 of the value (outputs reach ~100 at the model shape).
K2_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K3_TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-2, 2.0 ** -7)}
# K3's training variant's run-start states against the plain version's:
# f32 on both sides from the same inputs in either dtype, so f32's share
# of the largest magnitude (h kept at bf16 would be ~4e-3 off)
K3_STATES_TOL = 1e-4
LM_SMALL_TOL = 1e-3     # f32 logits of order 5, card vs CPU sum orders
LM_SMALL_TOKENS = (2, 256)
PREFILL_B, PREFILL_S, PREFILL_LAYERS = 2, 4096, 16
PREFILL_K2, PREFILL_K3 = 2, 14    # attention and Mamba layers of 16


def _dtypes():
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def k2_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, window, elem_bytes):
    """Least time for attention's work: the larger of q, k, v, o bytes
    over the memory rate and the score and output products of the
    unmasked (q, k) pairs over the bf16 tensor-core peak."""
    import numpy as np
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    flops = 4.0 * B * Hq * D * float(ok.sum())
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * elem_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def k3_bound_ms(B, S, Di, N, elem_bytes, with_states=False):
    """Least time for the scan: the larger of its bytes (x, dt, B, C in,
    y out; A, D f32 in; with ``with_states``, the training variant's f32
    run-start states, (B, Di, ceil(S / RUN), N), out too) over the
    memory rate and its f32 operations (per state element: the dt*A
    product, the exponential, three products and two sums; per channel
    step three more) over the f32 peak."""
    from repro_torch.kernels import selective_scan as SS
    nbytes = (3 * B * S * Di + 2 * B * S * N) * elem_bytes + 4 * (Di * N + Di)
    if with_states:
        nbytes += 4 * B * Di * SS.n_runs(S) * N
    ops = 7.0 * B * S * Di * N + 3.0 * B * S * Di
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _k2_inputs(case, dtype, gen):
    import torch
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def phase_k2():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for case in K2_CASES + [K2_MODEL]:
        causal, win = case[6], case[7]
        for name, dtype in _dtypes().items():
            q, k, v = _k2_inputs(case, dtype, gen)
            got = FA.flash_attention(q, k, v, causal=causal,
                                     sliding_window=win)
            want = FA.flash_attention_plain(q, k, v, causal=causal,
                                            sliding_window=win)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not err < K2_TOL[name]:
                raise AssertionError(f"k2 {case} {name}: kernel vs plain "
                                     f"max abs err {err} >= {K2_TOL[name]}")
            worst = max(worst, err)
            rows.append({"case": list(case), "dtype": name,
                         "max_abs_err": err})
            del got, want
        del q, k, v
    torch.cuda.empty_cache()
    q, k, v = _k2_inputs(K2_MODEL, torch.bfloat16, gen)
    causal, win = K2_MODEL[6], K2_MODEL[7]
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=causal,
                                            sliding_window=win), rounds=5)
    plain_ms = cuda_ms(lambda: FA.flash_attention_plain(
        q, k, v, causal=causal, sliding_window=win), rounds=3, warmup=1)
    # the yardstick: one PyTorch call on the same inputs (never used by
    # the port), on (B, H, S, D) copies made outside the timing
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    sdpa_err = float((sdpa().transpose(1, 2).float()
                      - FA.flash_attention(q, k, v).float()).abs().max())
    library_ms = cuda_ms(sdpa, rounds=10)
    bound, by = k2_bound_ms(*K2_MODEL, elem_bytes=2)
    # a CUDA input the bf16 kernel cannot take raises, with no detour to
    # the plain version: a contiguous view 2 bytes past an aligned base
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device="cuda")[1:].view(q.shape)
    before = FA.launches
    try:
        FA.flash_attention(shifted, k, v)
        raise AssertionError("k2: an unaligned bf16 q did not raise")
    except ValueError:
        pass
    if FA.launches != before:
        raise AssertionError("k2: the unaligned call launched a kernel")
    emit({"phase": "k2", "cases": rows, "all_match": True,
          "model_shape": list(K2_MODEL), "dtype": "bfloat16", "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
          "sdpa_ms": library_ms, "sdpa_vs_kernel_max_abs": sdpa_err,
          "kernel_over_sdpa": ms / library_ms})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def _k3_inputs(case, dtype, gen):
    import torch
    import torch.nn.functional as F
    B, S, Di, N = case
    x = torch.randn((B, S, Di), generator=gen, device="cuda")
    dt = F.softplus(torch.randn((B, S, Di), generator=gen, device="cuda")
                    - 1)
    A = -torch.exp(torch.randn((Di, N), generator=gen, device="cuda") * 0.5)
    Bc = torch.randn((B, S, N), generator=gen, device="cuda")
    Cc = torch.randn((B, S, N), generator=gen, device="cuda")
    D = torch.ones((Di,), device="cuda")
    return x.to(dtype), dt.to(dtype), A, Bc.to(dtype), Cc.to(dtype), D


def phase_k3():
    """K3 against its plain version; its training variant (``with_states``)
    gives K3's y bit for bit and the plain version's run-start states
    (f32 on both sides: within ``K3_STATES_TOL`` of their largest
    magnitude in both dtypes); times of both at the model shape, in
    turns, each beside its own bound and plain time.  -> (K3's row, the
    variant's row) of the ``kernels`` line."""
    import torch
    from repro_torch.kernels import selective_scan as SS
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst, worst_train = [], 0.0, 0.0
    for case in K3_CASES + [K3_MODEL]:
        for name, dtype in _dtypes().items():
            args = _k3_inputs(case, dtype, gen)
            y = SS.selective_scan(*args)
            y_train, states = SS.selective_scan(*args, with_states=True)
            want, want_states = SS.selective_scan_plain(*args,
                                                        with_states=True)
            torch.cuda.synchronize()
            if not torch.equal(y, y_train):
                raise AssertionError(f"k3 {case} {name}: the training "
                                     f"variant's y differs from K3's")
            got, want = y.float(), want.float()
            atol, rtol = K3_TOL[name]
            diff = (got - want).abs()
            err = float(diff.max())
            if not bool((diff <= atol + rtol * want.abs()).all()):
                raise AssertionError(f"k3 {case} {name}: kernel vs plain "
                                     f"max abs err {err} beyond {atol} + "
                                     f"{rtol} |plain|")
            if states.shape != want_states.shape:
                raise AssertionError(f"k3 {case} {name}: states "
                                     f"{tuple(states.shape)} vs plain "
                                     f"{tuple(want_states.shape)}")
            st_abs = float((states - want_states).abs().max())
            st_err = st_abs / max(float(want_states.abs().max()), 1e-30)
            if not st_err <= K3_STATES_TOL:
                raise AssertionError(f"k3 {case} {name}: states {st_err} "
                                     f"of the largest > {K3_STATES_TOL}")
            worst = max(worst, err)
            worst_train = max(worst_train, err, st_abs)
            rows.append({"case": list(case), "dtype": name,
                         "max_abs_err": err,
                         "max_abs_plain": float(want.abs().max()),
                         "train_y_same_bits": True,
                         "states_max_abs_err": st_abs,
                         "states_err_of_max": st_err})
            del args, y, y_train, states, want, want_states
    args = _k3_inputs(K3_MODEL, torch.bfloat16, gen)

    def k3():
        return SS.selective_scan(*args)

    def k3_train():
        return SS.selective_scan(*args, with_states=True)
    turns = [cuda_ms(fn, rounds=10) for fn in (k3, k3_train, k3_train, k3)]
    ms, train_ms = statistics.mean(turns[::3]), statistics.mean(turns[1:3])
    plain_ms = cuda_ms(lambda: SS.selective_scan_plain(*args), rounds=2,
                       warmup=1)
    train_plain_ms = cuda_ms(lambda: SS.selective_scan_plain(
        *args, with_states=True), rounds=2, warmup=0)
    bound, by = k3_bound_ms(*K3_MODEL, elem_bytes=2)
    train_bound, train_by = k3_bound_ms(*K3_MODEL, elem_bytes=2,
                                        with_states=True)
    emit({"phase": "k3", "cases": rows, "all_match": True,
          "states_tol_of_max": K3_STATES_TOL,
          "states_err_of_max_worst": max(r["states_err_of_max"]
                                         for r in rows),
          "model_shape": list(K3_MODEL), "dtype": "bfloat16", "ms": ms,
          "in_turns_ms": turns, "plain_ms": plain_ms, "bound_ms": bound,
          "bound_by": by, "library_ms": None,
          "train_variant": {"run": SS.RUN, "ms": train_ms,
                            "plain_ms": train_plain_ms,
                            "bound_ms": train_bound, "bound_by": train_by,
                            "states_bytes": 4 * K3_MODEL[0] * K3_MODEL[2]
                            * SS.n_runs(K3_MODEL[1]) * K3_MODEL[3]}})
    return ({"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None},
            {"max_abs_err": worst_train, "ms": train_ms,
             "plain_ms": train_plain_ms, "bound_ms": train_bound,
             "bound_by": train_by, "library_ms": None})


def _jamba(n_layers=None):
    from repro_torch.configs import get_config, reduced_config
    if n_layers is None:
        return reduced_config(get_config("jamba_v01_52b"), n_layers=8)
    return dataclasses.replace(get_config("jamba_v01_52b"),
                               n_layers=n_layers)


def phase_lm_small():
    """The reduced 8-layer Jamba in f32: the card's forward (K2, K3)
    against the CPU's (plain versions) on the same weights."""
    import torch
    from repro_torch import convert
    from repro_torch.models import model as MDL
    cfg = _jamba()
    params = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, LM_SMALL_TOKENS))
    want, want_aux = MDL.forward(params, cfg, tokens)
    got, aux = MDL.forward(convert.params_to(params, "cuda"), cfg,
                           tokens.cuda())
    got, aux = got.cpu(), aux.cpu()
    err = float((got - want).abs().max())
    aux_err = float((aux - want_aux).abs().max())
    if not (err < LM_SMALL_TOL and aux_err < LM_SMALL_TOL):
        raise AssertionError(f"lm_small: card vs CPU logits max abs err "
                             f"{err}, aux {aux_err} (tolerance "
                             f"{LM_SMALL_TOL})")
    emit({"phase": "lm_small", "match": True, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "tokens": list(LM_SMALL_TOKENS),
          "max_abs_err": err, "aux_max_abs_err": aux_err,
          "max_abs_logit": float(want.abs().max()), "tol": LM_SMALL_TOL})


def _device_time(prof) -> dict:
    """Device time (ms) of a profiled region: in all, by kernel group
    (K2, its backward, K3, its backward, cuBLAS matmuls, the rest) and
    its eight
    longest kernels."""
    import torch
    by_name, busy = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        busy += e.duration_ns()
        name = e.name()[:70]
        by_name[name] = by_name.get(name, 0) + e.duration_ns()
    groups = {"flash_attention (K2)": 0, "flash_attention_bwd": 0,
              "selective_scan (K3)": 0, "selective_scan_bwd": 0, "gemm": 0,
              "other": 0}
    for name, ns in by_name.items():
        low = name.lower()
        key = ("flash_attention (K2)" if "fa_fwd_" in name
               else "flash_attention_bwd" if any(
                   w in name for w in ("bwd_delta", "bwd_dkdv", "bwd_dq"))
               else "selective_scan (K3)" if "ssm_scan_fwd" in name
               else "selective_scan_bwd" if "ssm_scan_bwd" in name
               else "gemm" if any(w in low for w in ("gemm", "nvjet", "xmma",
                                                     "cutlass", "cublas"))
               else "other")
        groups[key] += ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy / 1e6,
            "device_ms_by_group": {k: v / 1e6 for k, v in groups.items()},
            "top_kernels_ms": [[n, ns / 1e6] for n, ns in top]}


def phase_lm_prefill():
    """Full-width Jamba cut to 16 layers, bf16: the prefill's kernel
    launches (its own main path), finiteness, tokens/s and where its
    device time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as MDL
    cfg = _jamba(PREFILL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = MDL.init_model(cfg, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    step = make_prefill_step(cfg)
    FA.launches = SS.launches = HM.launches = 0   # the prefill path starts
    logits = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = {"flash_attention": FA.launches,
                "selective_scan": SS.launches,
                "hier_minsearch": HM.launches}     # ... and ends here
    if launches != {"flash_attention": PREFILL_K2,
                    "selective_scan": PREFILL_K3, "hier_minsearch": 0}:
        raise AssertionError(f"lm_prefill launches {launches}, want K2 x"
                             f"{PREFILL_K2} and K3 x{PREFILL_K3}")
    if logits.shape != (PREFILL_B, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_prefill logits {tuple(logits.shape)} "
                             f"not finite or of the wrong shape")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, {"tokens": tokens})
        torch.cuda.synchronize()
    tokens_n = PREFILL_B * PREFILL_S
    emit({"phase": "lm_prefill", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "active_params": cfg.active_param_count(), "dtype": "bfloat16",
          "batch": PREFILL_B, "seq": PREFILL_S, "launches": launches,
          "finite": True, "init_s": init_s, "wall_s": walls,
          "tokens_per_s": tokens_n / wall, **_device_time(prof),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    del params, logits
    torch.cuda.empty_cache()
    return launches


def phase_lm_serve():
    """``serve()`` at full width (16 layers, bf16) on the card: the
    frozen control-plane result and decode ms per step; then a second
    run under the profiler for where the decode time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import goldens as G
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch import serve as SERVE
    from repro_torch.models import model as MDL
    cfg = _jamba(PREFILL_LAYERS)
    events = []
    decode_step = MDL.decode_step

    def timed_step(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = decode_step(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    MDL.decode_step = timed_step
    try:
        FA.launches = SS.launches = HM.launches = 0   # the serve path starts
        t0 = time.perf_counter()
        got = SERVE.serve(cfg, dtype=torch.bfloat16, verbose=lambda *_: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": FA.launches,
                    "selective_scan": SS.launches,
                    "hier_minsearch": HM.launches}    # ... and ends here
    finally:
        MDL.decode_step = decode_step
    if got != G.SERVE:
        raise AssertionError(f"lm_serve: {got} != frozen {G.SERVE}")
    step_ms = [s.elapsed_time(e) for s, e in events]
    torch.cuda.empty_cache()
    # the profiler starts at the first decode step, after the init
    prof = profile(activities=[ProfilerActivity.CUDA])

    def profiled_step(*args, **kw):
        if not prof_on:
            torch.cuda.synchronize()
            prof.start()
            prof_on.append(True)
        return decode_step(*args, **kw)

    prof_on = []
    MDL.decode_step = profiled_step
    try:
        again = SERVE.serve(cfg, dtype=torch.bfloat16,
                            verbose=lambda *_: None)
        torch.cuda.synchronize()
    finally:
        MDL.decode_step = decode_step
        if prof_on:
            prof.stop()
    if again != G.SERVE:
        raise AssertionError(f"lm_serve (profiled): {again} != {G.SERVE}")
    profiled = _device_time(prof)
    _check_decode_partial(cfg)
    emit({"phase": "lm_serve", "match": True, **got, "n_layers":
          cfg.n_layers, "dtype": "bfloat16", "decode_steps": len(step_ms),
          "decode_ms": step_ms,
          "decode_ms_median": statistics.median(step_ms),
          "decode_ms_median_after_first": statistics.median(step_ms[1:]),
          "wall_s": wall, "launches": launches,
          "profiled_decode": profiled})
    return launches


# card against CPU, f32 partials: |card - cpu| <= tol max(1, max|cpu|)
# per output (l sums thousands of terms in another order on the card)
DECODE_PARTIAL_TOL = 1e-5


def _check_decode_partial(cfg):
    """``ops.decode_attention_partial`` (plain torch, no kernel) on CUDA
    tensors against its CPU result at Jamba's decode shape: serve's batch
    of 4 over its 64-slot cache, and a 4,096-position shard of a
    sequence-parallel cache, in bf16, a quarter of each shard masked
    and one row of the long shard all masked."""
    import torch
    from repro_torch.kernels import ops
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    worst = {}
    for b, sloc in ((4, 64), (2, 4096)):
        g = torch.Generator().manual_seed(sloc)
        q = torch.randn((b, 1, hq, d), generator=g).to(torch.bfloat16)
        ck = torch.randn((b, sloc, hkv, d), generator=g).to(torch.bfloat16)
        cv = torch.randn((b, sloc, hkv, d), generator=g).to(torch.bfloat16)
        valid = torch.rand((b, sloc), generator=g) < 0.75
        if sloc > 64:
            valid[-1] = False
        cpu = ops.decode_attention_partial(q, ck, cv, valid)
        gpu = ops.decode_attention_partial(
            *(t.cuda() for t in (q, ck, cv, valid)))
        err = 0.0
        for name, c, x in zip(("acc", "m", "l"), cpu, gpu):
            x = x.cpu()
            fin = torch.isfinite(c)
            if not (torch.equal(fin, torch.isfinite(x))
                    and torch.equal(c[~fin], x[~fin])):
                raise AssertionError(f"decode_attention_partial {name}: "
                                     "masked rows differ")
            scale = max(1.0, c[fin].abs().max().item())
            err = max(err, (x[fin] - c[fin]).abs().max().item() / scale)
        worst[f"{b}x{sloc}"] = err
        if err > DECODE_PARTIAL_TOL:
            raise AssertionError(f"decode_attention_partial ({b}, {sloc}):"
                                 f" {err} > {DECODE_PARTIAL_TOL}")
    emit({"phase": "lm_serve", "check": "decode_attention_partial",
          "q": [None, 1, hq, d], "kv_heads": hkv, "max_scaled_err": worst,
          "tol": DECODE_PARTIAL_TOL})


# --------------------------------------------------------------------------
# The training path: K2's backward, the train step, olmo_1b at full width
# --------------------------------------------------------------------------

K2_BWD_TRAIN = (4, 2048, 2048, 16, 16, 128, True, 0)   # olmo_1b's training
K2_BWD_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window): GQA, windows, Sq < Skv,
    # lengths that are not multiples of the 64-row tiles, every head dim
    (2, 256, 256, 8, 2, 64, True, 0),
    (1, 333, 333, 2, 1, 128, True, 96),
    (2, 200, 328, 4, 2, 128, True, 0),
    (1, 130, 257, 2, 1, 16, True, 0),
    (1, 100, 200, 2, 2, 32, False, 0),
    (1, 256, 256, 4, 2, 64, False, 48),
    (4, 32, 32, 4, 4, 16, True, 0),       # the reduced olmo of the tests
    # whisper_medium's cross attention (Sq > Skv, no mask) and encoder,
    # glm4_9b's group of 16, minicpm_2b's 36 heads
    (1, 2048, 1500, 16, 16, 64, False, 0),
    (1, 1500, 1500, 16, 16, 64, False, 0),
    (1, 512, 512, 32, 2, 128, True, 0),
    (1, 333, 333, 36, 36, 64, True, 0),
]
# kernel vs plain on the same (q, k, v, out, lse, dout), element by
# element: |a - b| <= rtol |b| + atol max|b|, (rtol, atol) below.  f32 sums
# in two orders; bf16 adds one rounding of each output, which may fall on
# either side (one ulp, at most 2**-7 |b|, within rtol), and of ds, which
# moves a gradient by far less than atol.  A key tile left out of one late
# row's dq (an entry of a few hundredths off by about its own size) is
# held to about 1e-3, not to 1e-2 of the largest entry.
K2_BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
K2_LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}  # lse of order 10, f32
# the reduced olmo of tests/test_train_loop.py, card against CPU in f32:
# losses to 1e-5 relative, parameters after three steps to
# LM_TRAIN_SMALL_TOL (gradients agree to ~1e-6; Adam's first steps move
# each weight by about the learning rate, 1e-3, whatever the gradient's
# size, so the int8 run, where a gradient on a quantization step's edge
# may round either way, is held to two such moves)
LM_TRAIN_SMALL_TOL = {"none": 1e-4, "microbatches=2": 1e-4, "int8": 2e-3}
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 2048, 8


def _lm_train_run():
    """RunConfig's defaults (AdamW at 3e-4, cosine, bf16, remat "full")
    but for the schedule: the run is the first 8 steps of a 16-step
    schedule with a 4-step warmup.  Under the default 100-step warmup
    the 8th step's rate is 2.4e-5 and the loss moves less than its
    batch-to-batch spread; a 2-step warmup to the full rate makes the
    loss jump at step 4 (PERF.md §4)."""
    from repro_torch.configs import RunConfig
    return RunConfig(warmup_steps=4, total_steps=2 * LM_TRAIN_STEPS)


def k2_bwd_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, window, elem_bytes):
    """Least time for the backward's work: the larger of its bytes (q,
    k, v, out, dout, lse in; dq, dk, dv out) over the memory rate and its
    five products over the unmasked (q, k) pairs (s, dp, dv, dq, dk; 2 D
    flops each) over the bf16 tensor-core peak."""
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    flops = 10.0 * B * Hq * D * float(ok.sum())
    nbytes = (4 * B * Sq * Hq * D + 4 * B * Skv * Hkv * D) * elem_bytes \
        + 4 * B * Hq * Sq
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _bwd_device_ms(fn, reps: int, names=BWD_KERNEL_NAMES) -> dict:
    """Median device time (ms) per launch of each kernel of a backward
    (``names``, matched in the kernels' names; default the attention
    backward's three) over ``reps`` calls of ``fn`` (one backward each),
    from ``torch.profiler``'s kernel records, and the attempts it took.
    The launches sit inside idle margins of the profiled window (a run
    late in a long process has recorded none of a few-ms window); after
    three windows without every record the times are None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt, margin_s in enumerate((0.1, 0.5, 2.0), 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin_s)
        recs = {n: [] for n in names}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                for n in names:
                    if n in e.name():
                        recs[n].append(e.duration_ns())
        if all(len(r) == reps for r in recs.values()):
            return {"attempts": attempt, **{
                n: statistics.median(r) / 1e6 for n, r in recs.items()}}
    return {"attempts": attempt, "records": {n: len(r)
                                             for n, r in recs.items()},
            **{n: None for n in names}}


def phase_k2_bwd():
    """K2's forward with ``lse`` and the backward kernels against their
    plain versions, two backward launches bit for bit, times at olmo_1b's
    training shape, and K2 at the prefill shape with ``lse`` off and on."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst, out_worst = [], 0.0, 0.0
    for case in [K2_BWD_TRAIN] + K2_BWD_CASES:
        causal, win = case[6], case[7]
        mask = {"causal": causal, "sliding_window": win}
        for name, dtype in _dtypes().items():
            q, k, v = _k2_inputs(case, dtype, gen)
            dout = torch.randn(q.shape, generator=gen,
                               device="cuda").to(dtype)
            out, lse = FA.flash_attention(q, k, v, return_lse=True, **mask)
            out_p, lse_p = FA.flash_attention_plain(q, k, v, return_lse=True,
                                                    **mask)
            got = FA.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
            again = FA.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
            want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                **mask)
            torch.cuda.synchronize()
            # K2's forward at this shape: out and lse against plain
            out_err = float((out.float() - out_p.float()).abs().max())
            if not out_err < K2_TOL[name]:
                raise AssertionError(f"k2_bwd {case} {name}: out vs plain "
                                     f"max abs err {out_err} >= "
                                     f"{K2_TOL[name]}")
            lse_err = float((lse - lse_p).abs().max())
            if not lse_err < K2_LSE_TOL[name]:
                raise AssertionError(f"k2_bwd {case} {name}: lse vs plain "
                                     f"max abs err {lse_err}")
            rtol, atol = K2_BWD_TOL[name]
            errs = {}
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                a, b = a.float(), b.float()
                diff, limit = (a - b).abs(), rtol * b.abs() \
                    + atol * float(b.abs().max())
                errs[gname] = float(diff.max())
                errs[gname + "_of_limit"] = float((diff / limit).nan_to_num(
                    0.0, posinf=float("inf")).max())
                if not bool((diff <= limit).all()):
                    raise AssertionError(
                        f"k2_bwd {case} {name} {gname}: kernel vs plain "
                        f"exceeds {rtol} |plain| + {atol} max|plain| "
                        f"{errs[gname + '_of_limit']} times (max abs err "
                        f"{errs[gname]})")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"k2_bwd {case} {name}: two launches "
                                     f"differ")
            worst = max(worst, errs["dq"], errs["dk"], errs["dv"])
            out_worst = max(out_worst, out_err)
            rows.append({"case": list(case), "dtype": name, **errs,
                         "out_err": out_err, "lse_err": lse_err,
                         "same_bits": True})
            del q, k, v, dout, out, lse, out_p, lse_p, got, again, want
    torch.cuda.empty_cache()
    # times at the training shape, bf16: kernel, plain, and
    # scaled_dot_product_attention's backward on (B, H, S, D) copies
    case = K2_BWD_TRAIN
    q, k, v = _k2_inputs(case, torch.bfloat16, gen)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    out, lse = FA.flash_attention(q, k, v, return_lse=True)

    def bwd():
        return FA.flash_attention_bwd(q, k, v, out, lse, dout)
    ms = cuda_ms(bwd, rounds=5)
    plain_ms = cuda_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, out, lse, dout), rounds=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()

    def sdpa_bwd():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    library_ms = cuda_ms(sdpa_bwd, rounds=5)
    sdpa_err = max(float((a.transpose(1, 2).float() - b.float()).abs().max())
                   for a, b in zip(sdpa_bwd(), bwd()))
    f32 = [t.float() for t in (q, k, v, out, dout)]

    def bwd_f32():
        return FA.flash_attention_bwd(*f32[:4], lse, f32[4])
    ms_f32 = cuda_ms(bwd_f32, rounds=3)
    device_ms = {"bfloat16": _bwd_device_ms(bwd, reps=5),
                 "float32": _bwd_device_ms(bwd_f32, reps=2)}
    bound, by = k2_bwd_bound_ms(*case, elem_bytes=2)
    # a bf16 dout the kernels cannot take raises, with no detour: a
    # contiguous view 2 bytes past an aligned base
    shifted = torch.empty(dout.numel() + 1, dtype=dout.dtype,
                          device="cuda")[1:].view(dout.shape)
    before = FA.bwd_launches
    try:
        FA.flash_attention_bwd(q, k, v, out, lse, shifted)
        raise AssertionError("k2_bwd: an unaligned bf16 dout did not raise")
    except ValueError:
        pass
    if FA.bwd_launches != before:
        raise AssertionError("k2_bwd: the unaligned call launched a kernel")
    del q, k, v, dout, out, lse, qt, kt, vt, ot, dot, f32, shifted
    torch.cuda.empty_cache()
    # K2's forward at the prefill shape, lse off and on in turns
    q, k, v = _k2_inputs(K2_MODEL, torch.bfloat16, gen)
    fwd = {"off": lambda: FA.flash_attention(q, k, v),
           "on": lambda: FA.flash_attention(q, k, v, return_lse=True)}
    turns = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        turns[which].append(cuda_ms(fwd[which], rounds=5))
    del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "k2_bwd", "cases": rows, "all_match": True,
          "train_shape": list(case), "dtype": "bfloat16", "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
          "sdpa_bwd_ms": library_ms, "sdpa_vs_kernel_max_abs": sdpa_err,
          "kernel_over_sdpa": ms / library_ms, "ms_f32": ms_f32,
          "device_ms_by_kernel": device_ms,
          "k2_prefill_shape": list(K2_MODEL), "k2_lse_off_ms": turns["off"],
          "k2_lse_on_ms": turns["on"]})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "k2_out_max_abs_err": out_worst}


# the scan's backward: the JAX tests' scan cases, S and Di that are not
# multiples of the kernel's 16-step runs or of its channel blocks, N in
# {1, 4, 16, 64}, B = 1; and falcon_mamba_7b's training shape
K3_BWD_CASES = K3_CASES + [(1, 100, 130, 32), (2, 37, 20, 2),
                           (1, 300, 72, 4)]
K3_BWD_TRAIN = (4, 2048, 8192, 16)               # (B, S, Di, N)
# kernel vs plain on the same inputs and dy, each gradient held to a
# share of its largest magnitude: f32 sums in two orders (dA and dD sum
# B * S terms; dB and dC sum Di terms); bf16 adds one rounding of each
# output, which may fall on either side (2**-8 of the value)
K3_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K3_BWD_KERNEL_NAMES = ("ssm_scan_bwd<", "ssm_scan_bwd_sum")
K3_BWD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def k3_bwd_bound_ms(B, S, Di, N, elem_bytes):
    """Least time for the scan's backward: the larger of its bytes (x,
    dt, dy, B, C in and dx, ddt, dB, dC out in the input dtype; A, D in
    and dA, dD out in f32) over the memory rate and its f32 operations
    over the f32 peak: per state element 19 (dt*A and its exponential;
    the h update a*h + dt*x*B, 3; the adjoint a*lam + g*C, 3; the sums
    lam*B, 2, lam*A*(a*h), 3, and dA's lam*a*h*dt, 2; dB's lam*dt*x and
    dC's g*h with their channel sums, 4), per channel step 5 (dx, ddt,
    dD)."""
    nbytes = (5 * B * S * Di + 4 * B * S * N) * elem_bytes \
        + 8 * (Di * N + Di)
    ops = 19.0 * B * S * Di * N + 5.0 * B * S * Di
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_k3_bwd(build):
    """The scan's backward kernel against its plain version in f32 and
    bf16 (f32 A), from the forward's run-start states, two launches bit
    for bit (and the call without states, which makes them first, the
    same bits); at falcon_mamba_7b's training shape its times, the
    device split, the launch facts (run, cluster, shared memory, resident
    blocks and clusters) and ``build``'s ptxas and MUFU.EX2 counts."""
    import torch
    from repro_torch.kernels import selective_scan as SS
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for case in K3_BWD_CASES + [K3_BWD_TRAIN]:
        for name, dtype in _dtypes().items():
            args = _k3_inputs(case, dtype, gen)
            dy = torch.randn(args[0].shape, generator=gen,
                             device="cuda").to(dtype)
            _, states = SS.selective_scan(*args, with_states=True)
            got = SS.selective_scan_bwd(*args, dy, states)
            again = SS.selective_scan_bwd(*args, dy)
            want = SS.selective_scan_bwd_plain(*args, dy)
            torch.cuda.synchronize()
            errs = {}
            for gname, a, b in zip(K3_BWD_GRADS, got, want):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"k3_bwd {case} {name} {gname}: "
                                         f"{a.dtype} {tuple(a.shape)} vs "
                                         f"plain {b.dtype} {tuple(b.shape)}")
                scale = float(b.float().abs().max())
                err = float((a.float() - b.float()).abs().max())
                errs[gname] = err
                errs[gname + "_of_max"] = err / max(scale, 1e-30)
                if not errs[gname + "_of_max"] <= K3_BWD_TOL[name]:
                    raise AssertionError(
                        f"k3_bwd {case} {name} {gname}: kernel vs plain "
                        f"max abs err {err}, {errs[gname + '_of_max']} of "
                        f"the largest |plain| {scale} > {K3_BWD_TOL[name]}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"k3_bwd {case} {name}: two launches "
                                     f"differ")
            worst = max(worst, *(errs[g] for g in K3_BWD_GRADS))
            rows.append({"case": list(case), "dtype": name, **errs,
                         "same_bits": True})
            del args, dy, states, got, again, want
    torch.cuda.empty_cache()
    args = _k3_inputs(K3_BWD_TRAIN, torch.bfloat16, gen)
    dy = torch.randn(args[0].shape, generator=gen,
                     device="cuda").to(torch.bfloat16)
    _, states = SS.selective_scan(*args, with_states=True)

    def bwd():
        return SS.selective_scan_bwd(*args, dy, states)
    ms = cuda_ms(bwd, rounds=5)
    # the plain version ran at this shape above: no warm-up call
    plain_ms = cuda_ms(lambda: SS.selective_scan_bwd_plain(*args, dy),
                       rounds=1, warmup=0)
    fwd_ms = cuda_ms(lambda: SS.selective_scan(*args), rounds=5)
    device_ms = _bwd_device_ms(bwd, reps=3, names=K3_BWD_KERNEL_NAMES)
    bound, by = k3_bwd_bound_ms(*K3_BWD_TRAIN, elem_bytes=2)
    info = SS.bwd_launch_info(K3_BWD_TRAIN[3], torch.bfloat16)
    if info["active_clusters"] < 1:
        raise AssertionError(f"k3_bwd: no cluster of the backward fits "
                             f"the card: {info}")
    del args, dy, states
    torch.cuda.empty_cache()
    emit({"phase": "k3_bwd", "cases": rows, "all_match": True,
          "tol_of_max": K3_BWD_TOL, "train_shape": list(K3_BWD_TRAIN),
          "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by, "k3_fwd_ms": fwd_ms,
          "device_ms_by_kernel": device_ms, "launch": info,
          "instances": build})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _olmo(reduced: bool):
    from repro_torch.configs import get_config, reduced_config
    cfg = get_config("olmo_1b")
    return reduced_config(cfg) if reduced else cfg


# the reduced configs trained beside the reduced olmo in phase
# lm_train_small (one plain run each, f32, batch 4 x 32: mixtral's window
# of 16 over 32 tokens)
LM_TRAIN_SMALL_FAMILIES = ("falcon_mamba_7b", "deepseek_moe_16b",
                           "mixtral_8x22b", "jamba_v01_52b", "qwen2_72b",
                           "glm4_9b", "minicpm_2b", "whisper_medium",
                           "internvl2_2b")
# the families trained at full width, cut in depth: 16 of falcon_mamba_7b's
# 64 layers (2.22 B parameters), 6 of deepseek_moe_16b's 28 (3.44 B)
LM_TRAIN_SSM_LAYERS, LM_TRAIN_MOE_LAYERS = 16, 6


def _small_steps(cfg, run, batches, dev, init):
    """Three ``make_train_step`` steps from ``init`` on ``dev``: ->
    (losses, the parameters after them on the CPU)."""
    from repro_torch import convert
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import optimizer as OPT
    from repro_torch.parallel import compression as COMP
    from repro_torch.pytree import leaves
    params = convert.params_to(init, dev)
    opt = OPT.init_opt_state(params, run)
    err = COMP.init_error_state(params)
    step = make_train_step(cfg, run, device=dev)
    losses = []
    for b in batches:
        if run.grad_compression == "int8":
            params, opt, err, m = step(params, opt, err, b)
        else:
            params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses, [p.cpu() for p in leaves(params)]


def _small_compare(what, res, tol, noise=()):
    """Losses to 1e-5 relative, parameters to ``tol``; the leaves whose
    index is in ``noise`` (gradient 0 in exact arithmetic, see
    ``_noise_leaves``) to ``NOISE_LEAF_TOL``."""
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(res["cuda"][0], res["cpu"][0]))
    errs = [float((a - b).abs().max())
            for a, b in zip(res["cuda"][1], res["cpu"][1])]
    param_err = max((e for i, e in enumerate(errs) if i not in noise),
                    default=0.0)
    noise_err = max((errs[i] for i in noise), default=0.0)
    if not (loss_err < 1e-5 and param_err <= tol
            and noise_err <= NOISE_LEAF_TOL):
        raise AssertionError(f"lm_train_small {what}: card vs CPU loss rel "
                             f"err {loss_err}, params max abs err "
                             f"{param_err}, zero-gradient leaves "
                             f"{noise_err}")
    out = {"losses_cuda": res["cuda"][0], "losses_cpu": res["cpu"][0],
           "loss_rel_err": loss_err, "param_max_abs_err": param_err,
           "tol": tol}
    if noise:
        out.update(zero_grad_leaves=len(noise),
                   zero_grad_leaf_max_abs_err=noise_err)
    return out


# Without RoPE a key bias adds q . bk to every score of a row, which the
# softmax cancels: its gradient is 0 in exact arithmetic, rounding noise
# on each side, and Adam moves the weight by up to the learning rate a
# step whatever the gradient's size (measured on the CPU: whisper's bk
# 0.4-1.5e-4 from its start after three steps).  Card and CPU are held
# to two such moves of three steps each.
NOISE_LEAF_TOL = 2 * 3 * 1e-3


def _noise_leaves(cfg, params) -> set:
    """Indices (in ``leaves`` order) of the key biases of a config
    without RoPE."""
    def paths(node, prefix=""):
        if isinstance(node, dict):
            return [p for k in sorted(node) for p in paths(node[k],
                                                          f"{prefix}/{k}")]
        if isinstance(node, list):
            return [p for i, n in enumerate(node) for p in paths(
                n, f"{prefix}/{i}")]
        return [prefix]
    if cfg.rope_theta:
        return set()
    return {i for i, p in enumerate(paths(params)) if p.endswith("/bk")}


def phase_lm_train_small():
    """The reduced olmo in f32: three train steps (plain, microbatches=2,
    int8) on the card against the same steps on the CPU, from the same
    weights and batches; then every other family's reduced config the
    same way (plain run; whisper_medium's and internvl2_2b's with their
    frames and patches in f32), the SSM and hybrid ones through the
    scan's backward kernel."""
    import torch
    from repro_torch.configs import RunConfig, get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.models import model as MDL
    cfg = _olmo(reduced=True)
    base = RunConfig(param_dtype="float32", learning_rate=1e-3,
                     total_steps=30, warmup_steps=2, schedule="constant")
    runs = {"none": base,
            "microbatches=2": dataclasses.replace(base, microbatches=2),
            "int8": dataclasses.replace(base, grad_compression="int8")}
    batches = [synth_batch(cfg, 4, 32, DataConfig(), s) for s in range(3)]
    init = MDL.init_model(cfg, torch.float32, seed=0, device="cpu")
    out = {}
    for label, run in runs.items():
        res = {dev: _small_steps(cfg, run, batches, dev, init)
               for dev in ("cpu", "cuda")}
        out[label] = _small_compare(label, res, LM_TRAIN_SMALL_TOL[label])
    families = {}
    for name in LM_TRAIN_SMALL_FAMILIES:
        fcfg = reduced_config(get_config(name))
        # the frontends' bf16 patches and frames in f32, so that both
        # sides run the whole model in f32
        fb = [{k: v.float() if isinstance(v, torch.Tensor) else v
               for k, v in synth_batch(fcfg, 4, 32, DataConfig(), s).items()}
              for s in range(3)]
        finit = MDL.init_model(fcfg, torch.float32, seed=0, device="cpu")
        cpu = _small_steps(fcfg, base, fb, "cpu", finit)
        before = SS.bwd_launches
        res = {"cpu": cpu, "cuda": _small_steps(fcfg, base, fb, "cuda",
                                                finit)}
        scan_bwd = SS.bwd_launches - before
        if (fcfg.ssm is not None) != (scan_bwd > 0):
            raise AssertionError(f"lm_train_small {name}: {scan_bwd} "
                                 f"launches of the scan's backward")
        families[name] = {**_small_compare(name, res,
                                           LM_TRAIN_SMALL_TOL["none"],
                                           _noise_leaves(fcfg, finit)),
                          "n_layers": fcfg.n_layers,
                          "scan_bwd_launches": scan_bwd}
    emit({"phase": "lm_train_small", "match": True, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": 4, "seq": 32, "steps": 3,
          "runs": out, "families": families})


def _lm_train_path(phase, cfg, want_per_step, run=None, *,
                   then="profile"):
    """``cfg`` at full width in bf16 through ``launch.train.train``
    (``run``, default ``_lm_train_run``), batch 4 x 2048 from a seeded
    init (its own main
    path: the launch counts are zeroed before it and read after):
    launches a step against ``want_per_step``, finite losses, the last
    below the first; tokens/s, ms per step, peak memory, and one more
    step ``then``: "profile"d, or "count"ed by ``launch/op_cost`` (its
    FLOPs, the dry run's gate), or none (None).  -> (launches, that
    step's metrics, the report)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch import op_cost
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    run = run or _lm_train_run()
    stamps = []

    def log(line):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = FA.bwd_launches = SS.launches = SS.bwd_launches = 0
    SS.states_launches = HM.launches = 0
    t0 = time.perf_counter()                   # the training path starts
    params, opt, losses = train(cfg, run, steps=LM_TRAIN_STEPS,
                                batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                                log_every=1, verbose=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()                  # ... and ends here
    want = {k: n * LM_TRAIN_STEPS for k, n in want_per_step.items()}
    if launches != want:
        raise AssertionError(f"{phase} launches {launches}, want {want}")
    values = [loss for _, loss in losses]
    if len(values) != LM_TRAIN_STEPS or not all(np.isfinite(values)) \
            or not values[-1] < values[0]:
        raise AssertionError(f"{phase} losses {values}: want "
                             f"{LM_TRAIN_STEPS} finite, the last below the "
                             f"first")
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    step_ms = 1e3 * statistics.median(step_s)
    peak = torch.cuda.max_memory_allocated()
    # one more step (updating the phase's own state in place, as the
    # loop's steps do) under the profiler, device time by kernel group,
    # or under op_cost
    extra, metrics = {}, None
    if then is not None:
        step = make_train_step(cfg, run, donate=True)
        batch = synth_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, DataConfig(),
                            LM_TRAIN_STEPS)
        torch.cuda.synchronize()
    if then == "profile":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
        extra["profiled_step"] = _device_time(prof)
    elif then == "count":
        (params, opt, metrics), real = op_cost.measure(step, params, opt,
                                                       batch)
        extra["counted_step"] = {"flops": real.flops,
                                 "hbm_bytes": real.hbm_bytes,
                                 "peak_bytes": real.peak_bytes}
    del params, opt
    torch.cuda.empty_cache()
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    report = {
        "phase": phase, "config": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": cfg.param_count(),
        "dtype": run.param_dtype, "remat": run.remat,
        "microbatches": run.microbatches,
        "grad_compression": run.grad_compression, "schedule": run.schedule,
        "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
        "steps": LM_TRAIN_STEPS, "launches": launches,
        "launches_per_step": {k: v / LM_TRAIN_STEPS
                              for k, v in launches.items()},
        "losses": values, "finite": True, "decreased": True,
        "wall_s": wall, "step_ms": [1e3 * s for s in step_s],
        "ms_per_step_after_first": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_mem_gib": peak / 2**30, "peak_bytes": peak, **extra}
    return launches, metrics, report


def phase_lm_train():
    """olmo_1b at full width (16 layers) in bf16: 32 K2 and 16 backward
    launches a step (under full remat each attention layer runs K2 twice
    a step, its backward once), no scan."""
    cfg = _olmo(reduced=False)
    launches, _, report = _lm_train_path(
        "lm_train", cfg, _train_want(cfg, _lm_train_run()))
    emit(report)
    return launches, report


def phase_lm_train_ssm():
    """falcon_mamba_7b at full width cut to 16 layers in bf16: every layer
    is a super-block under full remat, so 32 launches of K3's training
    variant and 16 of the scan's backward a step; no attention."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("falcon_mamba_7b"),
                              n_layers=LM_TRAIN_SSM_LAYERS)
    launches, _, report = _lm_train_path(
        "lm_train_ssm", cfg, _train_want(cfg, _lm_train_run()))
    emit(report)
    return launches, report


def phase_lm_train_moe():
    """deepseek_moe_16b at full width cut to 6 layers in bf16: layer 0 (the
    dense FFN) is a prefix layer outside remat, so 1 + 2 * 5 = 11 K2 and 6
    backward launches a step; gated only on what routing does not change
    (bf16 router logits may route a near-tie either way)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek_moe_16b"),
                              n_layers=LM_TRAIN_MOE_LAYERS)
    n_moe = cfg.n_layers - cfg.moe.first_dense
    launches, metrics, report = _lm_train_path("lm_train_moe", cfg, {
        "flash_attention": cfg.moe.first_dense + 2 * n_moe,
        "flash_attention_bwd": cfg.n_layers, "selective_scan": 0,
        "selective_scan_states": 0, "selective_scan_bwd": 0,
        "hier_minsearch": 0})
    # the router's statistics of the last step run (the profiled one),
    # each summed over the MoE layers as lm_loss sums them
    emit({**report, "moe_layers": n_moe,
          "last_step_load_balance": float(metrics["load_balance"]),
          "last_step_dropped_frac": float(metrics["dropped_frac"])})
    return launches


# --------------------------------------------------------------------------
# The reference's training configurations and entry points the card had
# not run: remat "none" and "dots", microbatches, int8, crash and
# resume, and the train and serve CLIs
# --------------------------------------------------------------------------

LM_REMAT_POLICIES = ("none", "dots")
# olmo_1b's 1x1 cells the dry run predicts beside phase lm_train_remat's
# card work, by their CLI arguments (phase shard predicts remat "full")
LM_DRYRUN_CELLS = {"remat=none": ("--remat", "none"),
                   "remat=dots": ("--remat", "dots"),
                   "microbatches=2": ("--microbatches", "2")}
# olmo_1b's losses under microbatches=2 and int8 against lm_train's,
# relative, step by step.  Step 1 sees the same weights and batch: int8
# compresses only the gradient, after the loss, so its first loss is
# lm_train's bit for bit; two microbatches run the same bf16 forward on
# half the rows each, where cuBLAS may split a product's sum otherwise,
# so a logit may round to its other bf16 neighbour (2**-8 of its size),
# and the loss, a mean of log-sum-exps less a logit (each within twice
# the largest logit change), moves by well under 2**-7 of itself.  From
# step 2 the weights differ by the rounding of the gradients (a sum of
# two microbatches in f32 against one bf16 gradient; int8's quantization
# step, carried to the next step by error feedback): Adam moves a weight
# by about the learning rate whatever its gradient's size, so a weight
# whose gradient rounds to the other side, or to zero, ends a unit or two
# of bf16's last place from lm_train's; 2**-6 of the loss (four bf16
# roundings) holds the logits' drift over 8 steps.
LM_ACCUM_TOL = {"first": 2.0 ** -7, "rest": 2.0 ** -6}
# phase lm_resume: olmo_1b at full width cut to 4 of 16 layers (bf16
# parameters, f32 moments: a 3.4 GB checkpoint), a checkpoint every 4
# steps, the crash at step 6 (after the step-4 checkpoint)
LM_RESUME_LAYERS, LM_RESUME_CKPT_EVERY, LM_RESUME_FAIL_AT = 4, 4, 6
# the documented CLI pair: reduced olmo_1b, 20 steps, a checkpoint every
# 5, the crash at step 12, so the resumed run starts at step 10
LM_CLI_STEPS, LM_CLI_CKPT_EVERY, LM_CLI_FAIL_AT = 20, 5, 12
LM_CLI_TIMEOUT_S = 240


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count, by the kernels line's keys."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    return {"flash_attention": FA.launches,
            "flash_attention_bwd": FA.bwd_launches,
            "selective_scan": SS.launches,
            "selective_scan_states": SS.states_launches,
            "selective_scan_bwd": SS.bwd_launches,
            "hier_minsearch": HM.launches}


def _train_want(cfg, run) -> dict:
    """Launches a step of a config whose layers all have one mixer
    (olmo_1b's attention, falcon_mamba_7b's scan), as ``run`` implies:
    per microbatch (int8 ignores them) each layer's forward once, again
    in the backward's recomputation unless remat is "none", and its
    backward once."""
    n = 1 if run.grad_compression == "int8" else run.microbatches
    fwd = (1 if run.remat == "none" else 2) * cfg.n_layers * n
    bwd = cfg.n_layers * n
    ssm = cfg.ssm is not None
    return {"flash_attention": 0 if ssm else fwd,
            "flash_attention_bwd": 0 if ssm else bwd,
            "selective_scan": 0,
            "selective_scan_states": fwd if ssm else 0,
            "selective_scan_bwd": bwd if ssm else 0, "hier_minsearch": 0}


def _dryrun_cut(out, arch, n_layers, remat):
    """``launch.dryrun.run_cell`` of ``arch`` cut to ``n_layers`` on the
    host's 1x1 mesh at the training shape under ``remat``, in a
    subprocess that writes its row to ``out`` (the CLI cuts no depth)."""
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    code = "\n".join([
        "import dataclasses, json",
        "from repro_torch.configs.base import RunConfig, ShapeConfig, "
        "get_config",
        "from repro_torch.launch import dryrun",
        f"cfg = dataclasses.replace(get_config({arch!r}), "
        f"n_layers={n_layers})",
        f"row = dryrun.run_cell(cfg, ShapeConfig('train_{B}x{S}', {S}, {B}, "
        f"'train'), mesh_kind='host', run=RunConfig(remat={remat!r}), "
        "verbose=False)",
        f"json.dump([row], open({str(out)!r}, 'w'))"])
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def _against_dryrun(name, row, report, gated: bool) -> dict:
    """A run's measured peak and counted FLOPs beside the dry run's
    prediction of its cell (``row``); with ``gated`` the peak must lie
    within SHARD_PEAK_TOL and the FLOPs be equal, one microbatch count
    as the run's."""
    ratio = row["peak_bytes_per_chip"] / report["peak_bytes"]
    out = {"peak_bytes_predicted": row["peak_bytes_per_chip"],
           "peak_bytes_measured": report["peak_bytes"], "peak_ratio": ratio,
           "flops_predicted": row["flops_per_chip"],
           "microbatches_predicted": row["microbatches"],
           "t_compute_s": row["t_compute_s"],
           "t_memory_s": row["t_memory_s"], "gated": gated}
    if "counted_step" in report:
        out["flops_real_step"] = report["counted_step"]["flops"]
    if gated and not (abs(ratio - 1.0) <= SHARD_PEAK_TOL
                      and row["flops_per_chip"] == out["flops_real_step"]
                      and row["microbatches"] == report["microbatches"]):
        raise AssertionError(f"dry run of {name}: {out}")
    return out


def _brief(report) -> dict:
    """A training run's numbers for a phase line."""
    keys = ("config", "n_layers", "remat", "microbatches",
            "grad_compression", "launches_per_step", "losses",
            "ms_per_step_after_first", "tokens_per_s", "step_ms",
            "peak_bytes", "peak_mem_gib", "counted_step", "wall_s")
    return {k: report[k] for k in keys if k in report}


def phase_lm_train_remat(base_olmo, base_ssm):
    """olmo_1b (16 layers) and falcon_mamba_7b (16 of 64) at full width
    in bf16 through ``launch.train.train`` under remat "none" and
    "dots", 8 steps each (each run its own main path): launches a step
    as the policy implies (``_train_want``), and the 8 losses bit for bit
    those of phases lm_train and lm_train_ssm (remat "full": a policy
    changes what is kept, not a value, and the K2 and K3 backwards sum in
    a fixed order).  Beside them, in subprocesses, the dry run of
    olmo_1b's 1x1 cell under each policy and under microbatches=2 (the
    CLI) and of falcon's cut cell under each policy: olmo_1b's
    predictions within SHARD_PEAK_TOL of the measured peak and their
    FLOPs equal to a counted real step's (microbatches=2's in phase
    lm_train_accum); falcon's reported.  -> (the runs' launches, the
    microbatches=2 prediction)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out_dir = REPO / "chiprun_out" / "lm_train_remat"
    out_dir.mkdir(parents=True, exist_ok=True)
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    procs = {}
    for cell, args in LM_DRYRUN_CELLS.items():
        path = out_dir / f"olmo_1b_{cell.replace('=', '_')}.json"
        procs[f"olmo_1b {cell}"] = (_dryrun(
            path, "--shape", "train_4k", "--mesh", "host", "--batch",
            str(B), "--seq", str(S), *args), path)
    for policy in LM_REMAT_POLICIES:
        path = out_dir / f"falcon_mamba_7b_remat_{policy}.json"
        procs[f"falcon_mamba_7b remat={policy}"] = (_dryrun_cut(
            path, "falcon_mamba_7b", LM_TRAIN_SSM_LAYERS, policy), path)
    olmo = _olmo(reduced=False)
    falcon = dataclasses.replace(get_config("falcon_mamba_7b"),
                                 n_layers=LM_TRAIN_SSM_LAYERS)
    launches, runs = [], {}
    try:
        for cfg, base in ((olmo, base_olmo), (falcon, base_ssm)):
            for policy in LM_REMAT_POLICIES:
                run = dataclasses.replace(_lm_train_run(), remat=policy)
                name = f"{cfg.name} remat={policy}"
                n, _, report = _lm_train_path(
                    "lm_train_remat", cfg, _train_want(cfg, run), run,
                    then="count" if cfg is olmo else None)
                if report["losses"] != base["losses"]:
                    raise AssertionError(
                        f"lm_train_remat {name}: losses {report['losses']} "
                        f"!= remat full's {base['losses']}")
                launches.append(n)
                runs[name] = {**_brief(report), "losses_equal_full": True,
                              "full_peak_bytes": base["peak_bytes"]}
        deadline = time.perf_counter() + SHARD_DRYRUN_TIMEOUT_S
        rows = {name: _dryrun_row(p, path, deadline)
                for name, (p, path) in procs.items()}
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, r in runs.items():
        r["dryrun"] = _against_dryrun(name, rows[name], r,
                                      gated=name.startswith("olmo_1b"))
    emit({"phase": "lm_train_remat", "dtype": "bfloat16",
          "batch": B, "seq": S, "steps": LM_TRAIN_STEPS, "runs": runs,
          "peak_tol": SHARD_PEAK_TOL, "seconds": time.perf_counter() - t0})
    return launches, rows["olmo_1b microbatches=2"]


def phase_lm_train_accum(base, mb2_row):
    """olmo_1b at full width in bf16 through ``launch.train.train`` under
    microbatches=2 and under int8 gradient compression, 8 steps each
    (each its own main path): launches a step (``_train_want``), finite
    losses, the last below the first, each loss within LM_ACCUM_TOL of
    phase lm_train's (int8's first bit for bit); microbatches=2's peak
    and counted FLOPs against the dry run's prediction (``mb2_row``,
    from phase lm_train_remat), and each peak beside lm_train's.
    -> the runs' launches."""
    t0 = time.perf_counter()
    cfg = _olmo(reduced=False)
    launches, runs = [], {}
    for label, kw in (("microbatches=2", {"microbatches": 2}),
                      ("int8", {"grad_compression": "int8"})):
        run = dataclasses.replace(_lm_train_run(), **kw)
        n, _, report = _lm_train_path(
            "lm_train_accum", cfg, _train_want(cfg, run), run,
            then="count" if label == "microbatches=2" else None)
        rel = [abs(a - b) / abs(b)
               for a, b in zip(report["losses"], base["losses"])]
        first = report["losses"][0] == base["losses"][0] \
            if label == "int8" else rel[0] <= LM_ACCUM_TOL["first"]
        if not (first and max(rel[1:]) <= LM_ACCUM_TOL["rest"]):
            raise AssertionError(f"lm_train_accum {label}: losses "
                                 f"{report['losses']} against lm_train's "
                                 f"{base['losses']} (relative {rel})")
        launches.append(n)
        runs[label] = {**_brief(report), "losses_lm_train": base["losses"],
                       "loss_rel_err": rel,
                       "peak_over_lm_train": report["peak_bytes"]
                       / base["peak_bytes"]}
        if label == "microbatches=2":
            runs[label]["dryrun"] = _against_dryrun(
                f"olmo_1b {label}", mb2_row, runs[label], gated=True)
    emit({"phase": "lm_train_accum", "config": cfg.name, "dtype": "bfloat16",
          "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
          "steps": LM_TRAIN_STEPS, "tol": LM_ACCUM_TOL,
          "lm_train_peak_bytes": base["peak_bytes"], "runs": runs,
          "seconds": time.perf_counter() - t0})
    return launches


def _cli_pair_and_serve(ckpt_dir) -> dict:
    """The reference's documented CLIs in subprocesses on the card: the
    train CLI (reduced olmo_1b, f32) crashing at LM_CLI_FAIL_AT, then
    resumed (the same command without ``--fail-at``, with ``--resume``)
    from the last checkpoint before the crash; beside them the serve CLI
    with its defaults (reduced olmo_1b, 64 requests)."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}

    def start(*args):
        return time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", *args], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(started):
        t0, proc = started
        try:
            out, err = proc.communicate(timeout=LM_CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"lm_resume: {proc.args[2]} timed out")
        return proc.returncode, out, err, time.perf_counter() - t0
    serve = start("repro_torch.launch.serve")
    try:
        cmd = ("repro_torch.launch.train", "--arch", "olmo_1b", "--reduced",
               "--steps", str(LM_CLI_STEPS), "--ckpt-every",
               str(LM_CLI_CKPT_EVERY), "--ckpt-dir", str(ckpt_dir))
        rc, _, err, t_crash = finish(start(*cmd, "--fail-at",
                                           str(LM_CLI_FAIL_AT)))
        failure = [ln for ln in err.splitlines() if "injected failure at "
                   f"step {LM_CLI_FAIL_AT}" in ln]
        if rc == 0 or not failure:
            raise AssertionError(f"lm_resume: train CLI with --fail-at "
                                 f"exited {rc}: {err[-2000:]}")
        rc_r, out_r, err_r, t_resumed = finish(start(*cmd, "--resume"))
        want = LM_CLI_FAIL_AT // LM_CLI_CKPT_EVERY * LM_CLI_CKPT_EVERY
        losses = [float(m) for m in re.findall(r"loss=(\S+)", out_r)]
        if rc_r != 0 or f"[train] resumed from step {want}" not in out_r \
                or not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"lm_resume: train CLI with --resume "
                                 f"exited {rc_r}: {out_r[-1000:]} "
                                 f"{err_r[-2000:]}")
        rc_s, out_s, err_s, t_served = finish(serve)
    finally:
        if serve[1].poll() is None:
            serve[1].kill()
            serve[1].communicate()
    if rc_s != 0 or "[serve] 64/64 finished" not in out_s:
        raise AssertionError(f"lm_resume: serve CLI exited {rc_s}: "
                             f"{out_s[-1000:]} {err_s[-2000:]}")
    return {"train_crash": {"rc": rc, "wall_s": t_crash,
                            "error": failure[-1].strip()},
            "train_resume": {"rc": rc_r, "wall_s": t_resumed,
                             "stdout": out_r.strip().splitlines()},
            "serve": {"rc": rc_s, "wall_s": t_served,
                      "stdout": out_s.strip().splitlines()}}


def phase_lm_resume(cli):
    """(a) olmo_1b at full width cut to LM_RESUME_LAYERS layers in bf16
    through ``launch.train.train`` (its own main path), 8 steps
    uninterrupted, then again with a checkpoint every 4 steps in a
    temporary directory and a failure injected at step 6, which must
    raise, then resumed: "resumed from step 4", and its parameters, both
    moments and the step counter after step 8 bit for bit (dtype
    included) the uninterrupted run's, its losses those of steps 5-8;
    step times around the saves reported.  (b) ``cli``, the future of
    ``_cli_pair_and_serve`` (the train CLI's crash and resume and the
    serve CLI in subprocesses, their launches their processes' own),
    which ``main`` starts before phase lm_train_remat so that it runs
    beside phases 30-32 (device-bound steps): its result.
    -> (a)'s launches."""
    import tempfile
    import torch
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch.train import train
    from repro_torch.pytree import leaves
    t0 = time.perf_counter()
    cfg = dataclasses.replace(_olmo(reduced=False),
                              n_layers=LM_RESUME_LAYERS)
    run = _lm_train_run()
    kw = dict(steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
              log_every=1)
    walls = {}

    def log(name, said=None):
        stamps = walls.setdefault(name, [time.perf_counter()])

        def verbose(line):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if said is not None:
                said.append(line)
        return verbose

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "ckpt")
        torch.cuda.empty_cache()
        FA.launches = FA.bwd_launches = SS.launches = 0
        SS.bwd_launches = SS.states_launches = HM.launches = 0
        p_u, o_u, l_u = train(cfg, run, verbose=log("uninterrupted"),
                              **kw)
        try:
            train(cfg, run, ckpt_dir=ckpt,
                  ckpt_every=LM_RESUME_CKPT_EVERY,
                  fail_at=LM_RESUME_FAIL_AT, verbose=log("crash"), **kw)
        except RuntimeError as e:
            if f"injected failure at step {LM_RESUME_FAIL_AT}" \
                    not in str(e):
                raise
            failure = str(e)
        else:
            raise AssertionError("lm_resume: the run with fail_at did "
                                 "not fail")
        committed = CKPT.committed_steps(ckpt)
        step_dir = Path(ckpt) / f"step_{committed[-1]:08d}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        said = []
        p_r, o_r, l_r = train(cfg, run, ckpt_dir=ckpt,
                              ckpt_every=LM_RESUME_CKPT_EVERY,
                              resume=True, verbose=log("resumed", said),
                              **kw)
        torch.cuda.synchronize()
        launches = _launch_counts()
    cli_out = cli.result()
    start = LM_RESUME_FAIL_AT // LM_RESUME_CKPT_EVERY * LM_RESUME_CKPT_EVERY
    steps_run = 2 * LM_TRAIN_STEPS + LM_RESUME_FAIL_AT - start
    want = {k: n * steps_run for k, n in _train_want(cfg, run).items()}
    if launches != want:
        raise AssertionError(f"lm_resume launches {launches}, want {want}")
    if committed != [start] or said[0] != f"[train] resumed from step "\
            f"{start}":
        raise AssertionError(f"lm_resume: committed {committed}, said "
                             f"{said[:1]}")
    pairs = list(zip(leaves((p_r, o_r.mu, o_r.nu, o_r.step)),
                     leaves((p_u, o_u.mu, o_u.nu, o_u.step)), strict=True))
    unequal = sum(not (a.dtype == b.dtype and torch.equal(a, b))
                  for a, b in pairs)
    if unequal or l_r != l_u[start:]:
        raise AssertionError(f"lm_resume: {unequal} of {len(pairs)} leaves "
                             f"differ from the uninterrupted run's; losses "
                             f"{l_r} against {l_u[start:]}")
    del p_u, o_u, p_r, o_r
    torch.cuda.empty_cache()
    emit({"phase": "lm_resume", "config": cfg.name,
          "n_layers": cfg.n_layers, "cut_from": 16, "dtype": run.param_dtype,
          "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
          "steps": LM_TRAIN_STEPS, "ckpt_every": LM_RESUME_CKPT_EVERY,
          "fail_at": LM_RESUME_FAIL_AT, "failure": failure,
          "resumed_from": start, "checkpoint_bytes": ckpt_bytes,
          "leaves_compared": len(pairs), "bitwise": True,
          "losses": [v for _, v in l_u],
          "launches": launches,
          # a save's snapshot runs in the caller's thread after its
          # step's log line: the next step's wall holds it
          "step_ms": {name: [1e3 * (b - a) for a, b in zip(s, s[1:])]
                      for name, s in walls.items()},
          "cli": cli_out, "seconds": time.perf_counter() - t0})
    return launches


def phase_replay():
    """The decision replay (``serving/replay.py``) of two ``record_s1``
    runs of ``sim.run`` on the card (``goldens.replay_runs``: m=64, k=8,
    interference seed 0, sim_len 3e5, ``min_search`` and
    ``staleness_weighted``): the ``dec_*`` leaves, the events and
    ``app_done`` bit for bit the JAX reference's (``goldens.REPLAY``),
    every recorded decision replayed through the wall-clock
    ``ClusterScheduler`` with no mismatch, and ``replay_trace`` driving a
    ``FleetSim`` until every recorded application is finished.  ->
    K1's launches on this path (read, not assumed: ``sim.run`` maps
    without it)."""
    import torch
    from repro_torch.core import goldens as G
    from repro_torch.core import workloads as W
    from repro_torch.core.sim import SimParams, run
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.serving import replay as R
    t0 = time.perf_counter()
    runs = G.replay_runs(SimParams, W.interference, run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = HM.launches
    rows = {}
    for mapping, (st, wl) in runs.items():
        got = G.replay_digest(st)
        if got != G.REPLAY[mapping]:
            raise AssertionError(f"replay {mapping}: digest {got} != the "
                                 f"reference's {G.REPLAY[mapping]}")
        p = SimParams(mapping=mapping, **G.REPLAY_PARAMS)
        trace = R.decision_trace(st, wl[1])
        report = R.replay_decisions(trace, p)
        fleet = R.replay_trace(st, wl, p)
        n_apps = int((st["app_arrive"] < 1e17).sum())
        if not trace or report.mismatches or len(fleet.finished) != n_apps \
                or fleet.active or fleet.pending:
            raise AssertionError(
                f"replay {mapping}: {len(report.mismatches)} mismatches of "
                f"{len(trace)} decisions; {len(fleet.finished)} of {n_apps} "
                f"applications finished")
        rows[mapping] = {"events": got["events_processed"],
                         "decisions": len(trace), "mismatches": 0,
                         "agreement": report.agreement,
                         "applications": n_apps,
                         "fleet_finished": len(fleet.finished),
                         "fleet_beacons_tx": fleet.beacons_tx}
    emit({"phase": "replay", **G.REPLAY_PARAMS, "seed": G.REPLAY_SEED,
          "sim_len": G.REPLAY_SIM_LEN, "digests_match": True,
          "runs": rows, "k1_launches": k1, "runs_wall_s": wall,
          "events_per_s": sum(r["events"] for r in rows.values()) / wall,
          "seconds": time.perf_counter() - t0})
    return k1


# the last five families at full width, bf16 (phase lm_families): each
# arch's depth on the card for its prefill and decode, and for its
# training (None: not trained on one card; qwen2_72b's one layer with its
# embeddings is 3.4 B parameters, ~40 GB of training state)
LM_FAMILIES = {
    # arch: (serving layers, training layers)
    "qwen2_72b": (16, None),
    "glm4_9b": (40, 8),
    "minicpm_2b": (40, 40),
    "internvl2_2b": (24, 24),
    "whisper_medium": (24, 24),
}
FAMILY_PREFILL_B, FAMILY_PREFILL_S = 2, 4096   # whisper: 2 x 2048 text
FAMILY_DECODE_B, FAMILY_DECODE_STEPS = 4, 8


def _family_cfg(arch, n_layers):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def _family_k2(cfg) -> int:
    """K2 launches of one forward: one a self-attention layer, and for an
    encoder-decoder one a cross attention and one an encoder layer."""
    return cfg.n_layers * (2 if cfg.family == "encdec" else 1) \
        + cfg.n_enc_layers


def _family_serve(cfg) -> dict:
    """``make_prefill_step`` on one batch (its own main path: K2 launched
    ``_family_k2`` times, finite logits; then tokens/s of the median of
    three more), and ``decode_step`` ``FAMILY_DECODE_STEPS`` times at
    batch ``FAMILY_DECODE_B`` from a fresh cache (an encoder-decoder's
    from the cross cache of its encoder's output: one encoder pass, K2
    ``n_enc_layers`` times; the decode steps launch none): ms a step,
    finite logits.  -> the report, with each path's launches."""
    import torch
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as MDL
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = MDL.init_model(cfg, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    seq = FAMILY_PREFILL_S // (2 if cfg.family == "encdec" else 1)
    batch = synth_batch(cfg, FAMILY_PREFILL_B, seq, DataConfig(), 0)
    step = make_prefill_step(cfg)

    def counts():
        return {"flash_attention": FA.launches,
                "flash_attention_bwd": FA.bwd_launches,
                "selective_scan": SS.launches, "hier_minsearch": HM.launches}

    FA.launches = FA.bwd_launches = SS.launches = HM.launches = 0
    logits = step(params, batch)                 # the prefill path starts
    torch.cuda.synchronize()
    prefill = counts()                           # ... and ends here
    want = {"flash_attention": _family_k2(cfg), "flash_attention_bwd": 0,
            "selective_scan": 0, "hier_minsearch": 0}
    if prefill != want:
        raise AssertionError(f"lm_families {cfg.name} prefill launches "
                             f"{prefill}, want {want}")
    if logits.shape != (FAMILY_PREFILL_B, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_families {cfg.name}: prefill logits "
                             f"{tuple(logits.shape)} not finite or of the "
                             f"wrong shape")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    tokens_n = FAMILY_PREFILL_B * seq
    del logits, batch
    # decode: greedy from token 0 at positions 0.. of a prefill-length cache
    B = FAMILY_DECODE_B
    FA.launches = FA.bwd_launches = SS.launches = HM.launches = 0
    with torch.no_grad():                        # the decode path starts
        kw = {}
        if cfg.family == "encdec":
            frames = synth_batch(cfg, B, 1, DataConfig(), 1)["frames"]
            kw = dict(enc_out=MDL.encode(params, cfg, frames.cuda()),
                      params=params)
        cache = MDL.init_cache(cfg, B, seq, torch.bfloat16, **kw)
        tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
        events, finite = [], True
        for pos in range(FAMILY_DECODE_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out, cache = MDL.decode_step(params, cfg, cache, tok, pos)
            end.record()
            events.append((start, end))
            finite = finite and bool(torch.isfinite(out).all())
            tok = out[:, -1:].argmax(-1)
        torch.cuda.synchronize()
    decode = counts()                            # ... and ends here
    want = dict(want, flash_attention=cfg.n_enc_layers)
    if decode != want or not finite:
        raise AssertionError(f"lm_families {cfg.name} decode launches "
                             f"{decode} (want {want}), finite {finite}")
    step_ms = [a.elapsed_time(b) for a, b in events]
    del params, cache, kw
    torch.cuda.empty_cache()
    return {"serve_layers": cfg.n_layers, "serve_params": cfg.param_count(),
            "init_s": init_s,
            "prefill": {"batch": FAMILY_PREFILL_B, "seq": seq,
                        "wall_s": walls,
                        "tokens_per_s": tokens_n / statistics.median(walls),
                        "launches": prefill},
            "decode": {"batch": B, "steps": FAMILY_DECODE_STEPS,
                       "cache_len": seq, "ms": step_ms,
                       "ms_median_after_first": statistics.median(
                           step_ms[1:]), "launches": decode},
            "serve_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "finite": True}


def phase_lm_families():
    """qwen2_72b, glm4_9b, minicpm_2b, internvl2_2b and whisper_medium at
    full width in bf16 with seeded weights (``LM_FAMILIES`` the depths):
    each arch's prefill and decode (``_family_serve``), and its training
    through ``launch.train.train`` as phase ``lm_train`` runs it (8 steps
    at 4 x 2048, remat ``full``; minicpm_2b under its WSD schedule,
    internvl2_2b with 256 patch tokens and 1,792 text tokens,
    whisper_medium with 2,048 text tokens against 1,500 frames): under
    remat ``full`` a step runs each forward K2 launch twice and each
    backward once.  -> the launches of all its main paths, summed."""
    total = {"flash_attention": 0, "flash_attention_bwd": 0}
    for arch, (serve_layers, train_layers) in LM_FAMILIES.items():
        t0 = time.perf_counter()
        report = {"phase": "lm_families", "config": arch,
                  **_family_serve(_family_cfg(arch, serve_layers))}
        for path in ("prefill", "decode"):
            for k in total:
                total[k] += report[path]["launches"][k]
        if train_layers is not None:
            cfg = _family_cfg(arch, train_layers)
            run = _lm_train_run()
            if arch == "minicpm_2b":
                run = dataclasses.replace(run, schedule="wsd")
            k2 = _family_k2(cfg)
            launches, _, train = _lm_train_path("lm_families", cfg, {
                "flash_attention": 2 * k2, "flash_attention_bwd": k2,
                "selective_scan": 0, "selective_scan_states": 0,
                "selective_scan_bwd": 0, "hier_minsearch": 0}, run)
            for k in total:
                total[k] += launches[k]
            report["train"] = {k: v for k, v in train.items()
                               if k not in ("phase", "config")}
        report["seconds"] = time.perf_counter() - t0
        emit(report)
    return total


# phase shard: the sharded cell on the card's 1x1 mesh against the
# unsharded step, and the dry run's prediction of it
SHARD_STEPS = 3
SHARD_PEAK_TOL = 0.25          # predicted peak within 25% of the measured
SHARD_DRYRUN_TIMEOUT_S = 300
# where phase shard's two dry runs write their rows (kept for phase
# paper_suite's roofline table): the 1x1 cell, then decode_32k on 16x16
SHARD_OUT = REPO / "chiprun_out" / "shard"
SHARD_DRYRUNS = ("host.json", "decode.json")


def _whole(t):
    """A DTensor's full value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _dryrun(out, *args):
    """Start ``launch.dryrun`` for olmo_1b in a subprocess writing to
    ``out``."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo_1b", *args, "--out", str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def _dryrun_row(proc, out, deadline) -> dict:
    try:
        _, err = proc.communicate(timeout=max(1.0, deadline
                                              - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dry run {out.name} timed out")
    if proc.returncode != 0:
        raise AssertionError(f"dry run {out.name} failed: "
                             f"{err[-2000:]}")
    row = json.loads(out.read_text())[0]
    if row.get("status") != "ok":
        raise AssertionError(f"dry run {out.name}: {row}")
    return row


def _terms(row) -> dict:
    keys = ("cell", "mesh", "flops_per_chip", "bytes_per_chip",
            "collective_bytes_per_chip", "t_compute_s", "t_memory_s",
            "t_collective_s", "bottleneck", "peak_bytes_per_chip",
            "fits_80gb", "microbatches", "trace_s")
    return {k: row[k] for k in keys}


def phase_shard(smi):
    """(a) A one-rank NCCL group (in-memory store) and ``make_host_mesh``
    (1x1): three olmo_1b training steps at full width (bf16, remat
    ``full``, batch 4 x 2048) through ``build_cell(...).step`` on DTensor
    parameters, whose losses and parameters after step 3 must equal the
    unsharded ``make_train_step``'s from the same seed and batches bit
    for bit, with K2 and its backward launched 32 and 16 times a step;
    the last step runs under ``launch/op_cost``.  (b) The dry run in two
    subprocesses (started first; CPU work beside (a)): that cell on a 1x1
    mesh and olmo_1b ``decode_32k`` on 16x16.  The 1x1 prediction's peak
    must be within 25% of ``torch.cuda.max_memory_allocated`` over (a)'s
    sharded steps and its FLOPs equal to the count of (a)'s real step.
    -> (a)'s launches (its own main path: zeroed before, read after)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import init_single_rank, make_host_mesh
    from repro_torch.launch.steps import (build_cell, make_train_step, place,
                                          place_cell)
    from repro_torch.models import model as MDL
    from repro_torch.optim import optimizer as OPT
    from repro_torch.pytree import leaves
    t0 = time.perf_counter()
    SHARD_OUT.mkdir(parents=True, exist_ok=True)
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    host_out, decode_out = (SHARD_OUT / name for name in SHARD_DRYRUNS)
    procs = [(_dryrun(host_out, "--shape", "train_4k", "--mesh", "host",
                      "--batch", str(B), "--seq", str(S)), host_out),
             (_dryrun(decode_out, "--shape", "decode_32k", "--mesh",
                      "single"), decode_out)]
    try:
        cfg = _olmo(reduced=False)
        run = _lm_train_run()
        dt = getattr(torch, run.param_dtype)
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                    synth_batch(cfg, B, S, DataConfig(), s).items()}
                   for s in range(SHARD_STEPS)]
        # the unsharded step: its losses, and its parameters on the host
        torch.cuda.empty_cache()
        params = MDL.init_model(cfg, dt, seed=run.seed)
        opt = OPT.init_opt_state(params, run)
        step = make_train_step(cfg, run, donate=True)
        want_losses = []
        for b in batches:
            params, opt, m = step(params, opt, b)
            want_losses.append(float(m["loss"]))
        want = [p.cpu() for p in leaves(params)]
        del params, opt, step, m
        torch.cuda.empty_cache()
        # the cell on the 1x1 mesh: the parameters are the DTensors' own
        # storage (a 1-rank shard is the whole tensor, no copy)
        init_single_rank("cuda")
        mesh = make_host_mesh("cuda")
        cell = build_cell(cfg, ShapeConfig(f"train_{B}x{S}", S, B, "train"),
                          mesh, run)
        params = MDL.init_model(cfg, dt, seed=run.seed)
        opt = OPT.init_opt_state(params, run)
        p_d, o_d, _ = place_cell(cell, (params, opt, batches[0]))
        del params, opt
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FA.launches = FA.bwd_launches = SS.launches = SS.bwd_launches = 0
        SS.states_launches = HM.launches = 0      # the shard path starts
        losses, per_step, step_s = [], [], []
        for i, b in enumerate(batches):
            bd = place(b, cell.in_specs[2], mesh)
            before = (FA.launches, FA.bwd_launches)
            ts = time.perf_counter()
            if i == SHARD_STEPS - 1:
                (p_d, o_d, m), real = op_cost.measure(cell.step, p_d, o_d,
                                                      bd, mesh=mesh)
            else:
                p_d, o_d, m = cell.step(p_d, o_d, bd)
            losses.append(float(_whole(m["loss"])))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
            per_step.append([FA.launches - before[0],
                             FA.bwd_launches - before[1]])
        peak = torch.cuda.max_memory_allocated()
        launches = _launch_counts()              # ... and ends here
        want_k2 = [2 * cfg.n_layers, cfg.n_layers]
        others = ("selective_scan", "selective_scan_states",
                  "selective_scan_bwd", "hier_minsearch")
        if any(n != want_k2 for n in per_step) or any(launches[k]
                                                      for k in others):
            raise AssertionError(f"shard launches {per_step} a step, "
                                 f"{launches}; want {want_k2}")
        if losses != want_losses:
            raise AssertionError(f"shard losses {losses} != unsharded "
                                 f"{want_losses}")
        got = [_whole(p).cpu() for p in leaves(p_d)]
        unequal = sum(not torch.equal(a, w) for a, w in zip(got, want))
        if len(got) != len(want) or unequal:
            raise AssertionError(f"shard: {unequal} of {len(want)} "
                                 f"parameters differ from the unsharded "
                                 f"step's after step {SHARD_STEPS}")
        del p_d, o_d, got, want, m
        torch.cuda.empty_cache()
        deadline = time.perf_counter() + SHARD_DRYRUN_TIMEOUT_S
        host, decode = (_dryrun_row(p, o, deadline) for p, o in procs)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ratio = host["peak_bytes_per_chip"] / peak
    if abs(ratio - 1.0) > SHARD_PEAK_TOL:
        raise AssertionError(f"shard: predicted peak "
                             f"{host['peak_bytes_per_chip']} B is {ratio:.3f}"
                             f" of the measured {peak} B")
    if host["flops_per_chip"] != real.flops:
        raise AssertionError(f"shard: predicted FLOPs "
                             f"{host['flops_per_chip']} != the real step's "
                             f"{real.flops}")
    emit({"phase": "shard", "nvidia_smi": smi, "config": cfg.name,
          "mesh": "1x1", "dtype": run.param_dtype, "remat": run.remat,
          "batch": B, "seq": S, "steps": SHARD_STEPS,
          "losses": losses, "losses_unsharded": want_losses,
          "bitwise": True, "params_compared": len(leaves(cell.args[0])),
          "launches_per_step": per_step, "step_ms": [1e3 * t for t in step_s],
          "peak_bytes_measured": peak,
          "peak_bytes_predicted": host["peak_bytes_per_chip"],
          "peak_ratio": ratio,
          "flops_real_step": real.flops,
          "flops_predicted": host["flops_per_chip"],
          "real_step_counted_peak_bytes": real.peak_bytes,
          "real_step_hbm_bytes": real.hbm_bytes,
          "dryrun_1x1": _terms(host),
          "dryrun_decode_32k_16x16": _terms(decode),
          "seconds": time.perf_counter() - t0})
    return launches


LOOP_COPY_BUDGET_S = 15.0      # the phase's share of TIME_LIMIT_S


def phase_loop_copy():
    """The lane loop's copies at the analysis CLI's paper combos
    (``analysis.loop_copy.lint_combo`` on the card: a dispatch mode and
    ``torch.profiler`` over lane steps 21-60): no finding, and copy
    kernels, their device time and bytes a step, within
    LOOP_COPY_BUDGET_S."""
    from repro_torch.analysis import loop_copy as LC
    from repro_torch.analysis.__main__ import PROFILES, combo_tag
    t0 = time.perf_counter()
    combos = {}
    for combo in PROFILES["paper"]:
        r = LC.lint_combo(**combo, device="cuda")
        if r["findings"]:
            raise AssertionError(f"loop_copy: {combo_tag(combo)} "
                                 f"{r['findings']}")
        combos[combo_tag(combo)] = {
            key: r[key] for key in ("budget_bytes", "steps", "warmup",
                                    "copy_count", "copy_bytes_per_iter",
                                    "make_count", "make_bytes_per_iter",
                                    "largest_copy_elems")} | r["card"]
    wall = time.perf_counter() - t0
    if wall > LOOP_COPY_BUDGET_S:
        raise AssertionError(f"loop_copy: {wall:.1f} s over its "
                             f"{LOOP_COPY_BUDGET_S} s budget")
    emit({"phase": "loop_copy", "findings": 0, "combos": combos,
          "wall_s": wall, "budget_s": LOOP_COPY_BUDGET_S})


# --------------------------------------------------------------------------
# The suite runner, the regression gate, the examples and pmap
# --------------------------------------------------------------------------

SUITE_BUDGET_S = 90.0          # the phase's share of TIME_LIMIT_S
# the loop steps of each suite step that the profiler records before it
# pauses until the step ends: a whole eager step puts ~500 events a lane
# step into the trace (210 MB for the golden grid's 630 steps, measured;
# the suite's trace 114 MB at 25 steps a step, 84 MB at 10)
SUITE_SAMPLE_STEPS = 10
# the arguments scheduler_overhead's sweep-engine bench (``_bench_sweep``)
# gets here, cut from the reference's sim_len 3e5 and 3 timed calls
# (~50 s on the card) for the phase's time
SUITE_SO_SWEEP = dict(sim_len=3e4, iters=1)
# tests/test_torch_paper.py's TINY_TREE (topology_frontier's paper_tiny
# tier cut to m=16 and sim_len 1e5), cut again for the phase's time to
# sim_len 3e4 on ideal and hier_tree at k in (4, 16) (two runs at 1e5 on
# three fabrics took 54 s on the card; the runner's claims need both
# fabrics and a k above 1, and at 1.5e4 no application arrives)
SUITE_TREE = dict(m=16, ks=(4, 16), n_childs=16, max_apps=32,
                  queue_cap={16: 1024}, default_queue_cap=512, c_s=40.0,
                  dn_th=4, sim_len=3e4, pair_periods=(26_000.0,),
                  seeds=(0, 1), queue_impl="tree", batch_pop=64,
                  topologies=("ideal", "hier_tree"))
SUITE_PMAP_WORKERS = 2         # pmap's workers on cuda:0
SUITE_PMAP_KS = (4, 2)         # the golden grid's k, then a second group
SUITE_DEVICE = "cuda"
FRONTIERS = ("fault_frontier", "policy_frontier", "trace_report")
SUITE_STEPS = ("scheduler_overhead", "fault_frontier", "policy_frontier",
               "trace_report", "topology_frontier",
               "topology_frontier_again", "serve_clustered", "pmap",
               "pmap_workers", "paper_repro")
# what the phase keeps for its end after the last step: the profiler's
# stop, the trace's export and parse, the checks (5.4-8.0 s on fast
# hosts, more on slow ones)
SUITE_END_S = 12.0


def _paper_repro_horizon(elapsed: float, paper_eps: float):
    """``paper_repro``'s horizon, the suite's last step, and its
    predicted seconds at 1e5: the example's events there
    (``goldens.PAPER_REPRO``) at phase ``paper``'s events/s.  1e5 as the
    tests run it, unless it would take the phase past
    ``SUITE_BUDGET_S`` (a slow host), then 5e4."""
    from repro_torch.core import goldens as G
    full, cut = sorted(G.PAPER_REPRO, reverse=True)
    predicted = G.PAPER_REPRO[full]["events"] / paper_eps
    if elapsed + predicted + SUITE_END_S <= SUITE_BUDGET_S:
        return full, predicted
    return cut, predicted


class _Sampled(_Steps):
    """Counts the loops' iterations a thread (``_Steps``' hooks) and
    pauses ``prof``'s collection at the ``keep``-th of a suite step: CPU
    and CUDA on the main thread, CUDA alone from a ``pmap`` worker (the
    profiler records no torch op of another thread).  ``body(fn)`` runs
    a step's function from a zero count and resumes collection before
    the step's region closes."""

    def __init__(self, prof, keep: int):
        import threading
        self.prof, self.keep = prof, keep
        self.local, self.off = threading.local(), set()

    def _counted(self, fn):
        import threading

        from torch.profiler import ProfilerActivity as PA

        def counted(*args, **kw):
            out = fn(*args, **kw)
            self.local.n = getattr(self.local, "n", 0) + 1
            if self.local.n == self.keep:
                acts = ((PA.CPU, PA.CUDA)
                        if threading.current_thread()
                        is threading.main_thread() else (PA.CUDA,))
                for act in set(acts) - self.off:
                    self.off.add(act)
                    self.prof.toggle_collection_dynamic(False, [act])
            return out
        return counted

    def body(self, fn):
        def run(*args, **kw):
            self.local.n = 0
            try:
                return fn(*args, **kw)
            finally:
                for act in sorted(self.off, key=str):
                    self.prof.toggle_collection_dynamic(True, [act])
                self.off.clear()
        return run


def _trace_regions(path, names) -> dict:
    """Per step name, the CUDA kernels that start inside its one
    ``record_function`` region of the Chrome trace at ``path``."""
    import bisect
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    regions = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            regions.setdefault(e["name"], []).append(e)
    starts = sorted(e["ts"] for e in events if e.get("cat") == "kernel")
    out = {}
    for name in names:
        found = regions.get(name, [])
        if len(found) != 1:
            raise AssertionError(f"suite: {len(found)} trace regions "
                                 f"named {name!r}")
        lo, hi = found[0]["ts"], found[0]["ts"] + found[0]["dur"]
        out[name] = bisect.bisect_right(starts, hi) \
            - bisect.bisect_left(starts, lo)
    return out


def _bitwise(got: dict, want: dict) -> bool:
    """Every leaf equal bit for bit, dtype included (tensors are read to
    the host)."""
    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    return set(got) == set(want) and all(
        host(got[k]).dtype == host(want[k]).dtype
        and np.array_equal(host(got[k]), host(want[k])) for k in want)


def _example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn):
    """``fn`` with its printed lines kept in ``fn.lines``."""
    import contextlib
    import io

    def run(*args, **kw):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args, **kw)
        run.lines = buf.getvalue().splitlines()
        return out
    return run


def phase_suite(golden, paper_eps: float) -> int:
    """The suite runner's step wrapper (``benchmarks/run.Suite``) under
    its profiler (``run.profiler``, CPU and CUDA) on the card: the
    gated steps, their claims and digests against the JAX reference's,
    the regression gate between two ``topology_frontier`` runs, the two
    examples, and ``ExperimentSpec.run(mode="pmap")`` against vmap bit
    for bit (``golden``: phase ``sweep``'s vmap state of the golden
    grid); the Chrome trace holds one region a step, each with a CUDA
    kernel.  ``paper_eps``, phase ``paper``'s events/s in the same
    single loop, predicts ``paper_repro``'s time at 1e5 (see
    :func:`_paper_repro_horizon`).  The line is printed before a failed
    gate raises.  Returns the K1 launches of its
    ``scheduler_overhead`` and the ``tlm_loop`` launches of each step
    (the paper's program in ``policy_frontier``'s ideal groups, ``pmap``
    and ``paper_repro``; the other steps' programs run the host loop)."""
    import tempfile

    import torch
    from repro_torch.benchmarks import check_regression as CR
    from repro_torch.benchmarks import fault_frontier as FF
    from repro_torch.benchmarks import policy_frontier as PF
    from repro_torch.benchmarks import run as RUN
    from repro_torch.benchmarks import scheduler_overhead
    from repro_torch.benchmarks import topology_frontier as TF
    from repro_torch.benchmarks import trace_report as TR
    from repro_torch.core import experiment as E
    from repro_torch.core import goldens as G
    from repro_torch.core.sim import SimParams
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import tlm_loop as TL
    t_phase = time.perf_counter()
    # the K1 kernel phase k1 holds against the plain version at these
    # shapes
    if any(HM._variant(k, K1_M // k) != "warp" for k in K1_KS):
        raise AssertionError("suite: scheduler_overhead's shapes leave "
                             "the warp kernel")
    tmp = Path(tempfile.mkdtemp(prefix="suite_"))
    paper_repro = _example("paper_repro_torch")
    serve_clustered = _example("serve_clustered_torch")
    # the golden grid and the same grid at k=2: two groups, so that
    # pmap's two workers each run a lane loop at once
    spec = E.ExperimentSpec(
        base=SimParams(**G.GRID_PARAMS), shapes=SUITE_PMAP_KS,
        knobs={"dn_th": G.GRID_DN_TH},
        workloads=(E.WorkloadSpec("interference", seeds=G.GRID_SEEDS),),
        sim_len=G.GRID_SIM_LEN)
    workers = [torch.device(SUITE_DEVICE, 0)] * SUITE_PMAP_WORKERS
    saved = (TF.BENCH_PATH, TF.GRIDS["paper_tiny"], E.pmap_devices,
             scheduler_overhead._bench_sweep)
    TF.BENCH_PATH = str(tmp / "eventq_trajectory.json")
    TF.GRIDS["paper_tiny"] = SUITE_TREE
    scheduler_overhead._bench_sweep = functools.partial(
        saved[3], **SUITE_SO_SWEEP)
    suite = RUN.Suite(profile=True)
    prof = RUN.profiler(SUITE_DEVICE)
    out, trajectory, tlm = {}, [], {}
    try:
        with prof, _Sampled(prof, SUITE_SAMPLE_STEPS) as sampled:
            def step(name, fn, *args, **kw):
                before = TL.launches
                try:
                    return suite.step(name, sampled.body(fn), *args, **kw)
                finally:
                    tlm[name] = TL.launches - before

            before = HM.launches
            out["so"] = step("scheduler_overhead", scheduler_overhead.run,
                             verbose=False)
            so_launches = HM.launches - before
            for name, mod in zip(FRONTIERS, (FF, PF, TR)):
                out[name] = step(name, G.suite_run, name, mod)
            for name in ("topology_frontier", "topology_frontier_again"):
                # each run records its combos' copy bytes anew
                TF._COPY_BYTES.clear()
                step(name, TF.run, verbose=False, grid="paper_tiny")
                trajectory.append(json.loads(Path(TF.BENCH_PATH)
                                             .read_text()))
            sc = _quiet(serve_clustered.main)
            out["serve"] = step("serve_clustered", sc, [])
            one = step("pmap", spec.run, mode="pmap")
            E.pmap_devices = lambda device: workers
            two = step("pmap_workers", spec.run, mode="pmap")
            E.pmap_devices = saved[2]
            pr_len, pr_pred = _paper_repro_horizon(
                time.perf_counter() - t_phase, paper_eps)
            pr = _quiet(paper_repro.main)
            out["paper_repro"] = step("paper_repro", pr, [],
                                      sim_len=pr_len)
        trace = tmp / RUN.TRACE_NAME
        prof.export_chrome_trace(str(trace))
        trace_mb = trace.stat().st_size / 1e6
        kernels = _trace_regions(trace, SUITE_STEPS)
    finally:
        (TF.BENCH_PATH, TF.GRIDS["paper_tiny"], E.pmap_devices,
         scheduler_overhead._bench_sweep) = saved
        shutil.rmtree(tmp, ignore_errors=True)
    bad = []
    # scheduler_overhead: K1 against its plain version
    if so_launches == 0 or not all(
            out["so"]["two_stage_matches_plain"].values()):
        bad.append(("scheduler_overhead", so_launches,
                    out["so"]["two_stage_matches_plain"]))
    # the frontier runners: every claim, and the reference's digests
    for name in FRONTIERS:
        false = [k for k, v in out[name].items()
                 if k.startswith("claim") and v is not True]
        if false:
            bad.append((name, "claims", false))
    digests = G.suite_digest({name: out[name] for name in FRONTIERS})
    if digests != G.SUITE_DIGESTS:
        bad.append(("digests", digests))
    # the gate: the second topology run against the first
    rep = CR.check(trajectory[0], trajectory[1], "paper_tiny")
    sides = [e["status"] for e in rep["rows"] + rep["head_to_head"]]
    copy = rep["copy_bytes"]
    if {"new", "baseline-only"} & set(sides) or not copy or not all(
            e["status"] == "ok" and e["ratio"] == 1.0 for e in copy):
        bad.append(("check_regression", sides, copy))
    # paper_repro's numbers are the reference example's
    got = {"table5": {k: {"speedup_f32_bits": int(np.float32(r["speedup"])
                                                  .view(np.uint32)),
                          "apps": r["apps"], "beacons": r["beacons"]}
                      for k, r in out["paper_repro"]["table5"].items()},
           "fig3b": out["paper_repro"]["fig3b"]}
    want = G.PAPER_REPRO[pr_len]
    if got != {"table5": want["table5"], "fig3b": want["fig3b"]}:
        bad.append(("paper_repro", pr_len, got))
    if out["serve"] != G.SERVE_CLUSTERED:
        bad.append(("serve_clustered", out["serve"]))
    # pmap: vmap on one card, the golden grid's group equal to its
    # digests and phase sweep's state; two workers on cuda:0, one group
    # each, equal to it bit for bit
    g0 = next(g.state for g in one.groups
              if g.combo.shape.k == G.GRID_PARAMS["k"])
    if (one.mode, two.mode, two.devices, len(two.groups)) != (
            "vmap", "pmap", SUITE_PMAP_WORKERS, len(SUITE_PMAP_KS)):
        bad.append(("pmap modes", one.mode, two.mode, two.devices,
                    len(two.groups)))
    if [g0["beacons_tx"].tolist(), G.sha256_f32(g0["app_done"])] != [
            G.GRID_BEACONS, G.GRID_APP_DONE_SHA] \
            or not _bitwise(g0, golden):
        bad.append(("pmap", "golden grid"))
    if [g.combo for g in one.groups] != [g.combo for g in two.groups] \
            or not all(_bitwise(a.state, b.state)
                       for a, b in zip(one.groups, two.groups)) \
            or not all(np.isnan(g.wall_s) for g in two.groups):
        bad.append(("pmap", "two workers differ from vmap"))
    empty = [name for name, n in kernels.items() if n == 0]
    if empty:
        bad.append(("trace regions without a kernel", empty))
    if not all(tlm[name] for name in ("pmap", "pmap_workers",
                                      "paper_repro")):
        bad.append(("tlm_loop launches", tlm))
    wall = time.perf_counter() - t_phase
    if wall > SUITE_BUDGET_S:
        bad.append(("budget", wall, SUITE_BUDGET_S))
    failed = {b[0] if b[0] != "pmap" else b[1] for b in bad}
    emit({"phase": "suite", "ok": not bad, "failed": repr(bad),
          "claims": not failed & set(FRONTIERS),
          "digests_match": "digests" not in failed,
          "k1_launches": so_launches, "tlm_loop_launches": tlm,
          "so_sweep_cut": SUITE_SO_SWEEP,
          "us_per_decision": {k: r["us_per_decision"]
                              for k, r in out["so"]["two_stage"].items()},
          "grids": {name: G.SUITE_GRIDS[name] for name in FRONTIERS}
          | {"topology_frontier": SUITE_TREE},
          "gate": {"statuses": {s_: sides.count(s_) for s_ in set(sides)},
                   "worst_ratio": rep["worst_ratio"],
                   "copy_entries": len(copy),
                   "worst_copy_growth": rep["worst_copy_growth"]},
          "paper_repro": {"sim_len": pr_len,
                          "predicted_s_at_1e5": pr_pred,
                          "paper_events_per_s": paper_eps},
          "paper_repro_lines": pr.lines, "serve": out["serve"],
          "pmap": {"one_card": one.mode, "workers": two.devices,
                   "groups": len(two.groups),
                   "bitwise": not failed & {"golden grid",
                                            "two workers differ from vmap"}},
          "trace": {"mb": trace_mb, "sample_steps": SUITE_SAMPLE_STEPS,
                    "kernels_per_region": kernels},
          "walls_s": dict(suite.walls), "wall_s": wall,
          "budget_s": SUITE_BUDGET_S})
    if bad:
        raise AssertionError(f"suite: gates failed {bad}")
    return so_launches, tlm


# --------------------------------------------------------------------------
# The paper's headline comparison, Fig. 2, the suite's last steps and the
# user-facing examples
# --------------------------------------------------------------------------

PAPER_SUITE_BUDGET_S = 150.0   # the phase's share of TIME_LIMIT_S
# examples/train_tiny_lm_torch.py's crash and resume, cut in steps only
# (its default 300): the crash at step 30, a checkpoint every 6 steps
# (10 a run whatever the steps, ~2 s each at 1.37 GB).  The synthetic
# tokens hold the loss near ln(50304) = 10.83: at 60 steps the last
# logged loss is 0.098 below the first, at 30 steps 0.0026 (bit for bit
# on the card, but a margin a change of summation order could undo)
TINY_LM_ARGS = ("--steps", "60", "--crash-demo")
# examples/quickstart_torch.py at its default arch, and one with an SSM
QUICKSTART_ARCHS = ("glm4_9b", "falcon_mamba_7b")
# the quickstart's card losses against its CPU run from the same weights:
# relative, plus the printed four decimals
QUICKSTART_TOL, QUICKSTART_PRINT_TOL = 1e-3, 1e-4
# moe_balance: a token whose second and third router logits lie closer
# than this may route otherwise on the card (its product sums in another
# order, ~1e-6 apart at d_model 128), so its loads are held exactly only
# where no token is that close
MOE_TIE_EPS = 1e-4
MOE_LOAD_BALANCE_RTOL = 1e-5   # a mean of 1,024 f32 router probabilities


def _counted(path: dict, fn, *args, **kw):
    """``fn(*args, **kw)``, its launches added to ``path``."""
    before = _launch_counts()
    try:
        return fn(*args, **kw)
    finally:
        for key, n in _launch_counts().items():
            path[key] = path.get(key, 0) + n - before[key]


def _moe_check(card, cpu, loads, params, x) -> dict:
    """``moe_balance`` on the card against the same call on the CPU
    (``loads``: each call's share of the routed choices an expert, card
    then CPU): the near ties of the router (a token's second and third
    logits, in f64 on the CPU, within ``MOE_TIE_EPS``); with none, the
    loads, imbalance and dropped fraction equal, else each expert's load
    within one routed choice a near tie and the dropped fraction within
    two (a token that moves frees a slot of one expert and takes one of
    another); the load-balance loss within its rtol."""
    import torch
    from repro_torch.benchmarks import moe_balance as MB
    cfg = MB.config()
    logits = (x.double().reshape(-1, cfg.d_model)
              @ params["router"].double())
    top = torch.sort(logits, dim=-1, descending=True).values
    k = cfg.moe.top_k
    gap = top[:, k - 1] - top[:, k]
    ties = int((gap < MOE_TIE_EPS).sum())
    choices = logits.shape[0] * k
    exact = ("max_over_mean_expert_load", "dropped_frac", "n_experts",
             "top_k")
    if ties == 0:
        ok = loads[0] == loads[1] and all(card[key] == cpu[key]
                                          for key in exact)
    else:
        ok = (abs(card["dropped_frac"] - cpu["dropped_frac"])
              <= 2 * ties / choices
              and all(abs(a - b) <= ties / choices
                      for a, b in zip(*loads, strict=True))
              and card["n_experts"] == cpu["n_experts"])
    lb = abs(card["load_balance_loss"] - cpu["load_balance_loss"]) \
        <= MOE_LOAD_BALANCE_RTOL * abs(cpu["load_balance_loss"])
    return {"ok": bool(ok and lb), "near_ties": ties,
            "min_gap": float(gap.min()), "tokens": int(logits.shape[0]),
            "comparison": "exact" if ties == 0 else "within the ties",
            "loads_card": loads[0], "loads_cpu": loads[1], "card": card,
            "cpu": cpu}


def _tiny_lm(tmp: Path):
    """``examples/train_tiny_lm_torch.py`` with ``TINY_LM_ARGS`` on the
    card, its checkpoints under ``tmp``: -> (each ``train`` call's
    config, run, keywords and result or error, the printed lines)."""
    mod = _example("train_tiny_lm_torch")
    calls, train = [], mod.train

    def recorded(cfg, run, **kw):
        call = {"cfg": cfg, "run": run, "kw": kw}
        calls.append(call)
        try:
            call["out"] = train(cfg, run, **kw)
        except RuntimeError as e:
            call["error"] = str(e)
            raise
        return call["out"]
    mod.train = recorded
    main = _quiet(mod.main)
    argv, sys.argv = sys.argv, ["train_tiny_lm_torch.py", *TINY_LM_ARGS,
                                "--ckpt-dir", str(tmp),
                                "--device", SUITE_DEVICE]
    try:
        main()
    finally:
        sys.argv = argv
    return calls, train, main.lines


def _losses(lines) -> list:
    """The losses of the quickstart's ``train step i: loss=x`` lines."""
    return [float(line.rsplit("=", 1)[1]) for line in lines
            if line.startswith("train step")]


def _quickstart_want(arch) -> dict:
    """The quickstart's launches on ``arch``'s reduced config (one mixer
    kind): its forward (remat none) once a layer, three training steps
    as :func:`_train_want` under the quickstart's run, no decode
    launch."""
    from repro_torch.configs import RunConfig, get_config, reduced_config
    cfg = reduced_config(get_config(arch))
    run = RunConfig(param_dtype="float32", total_steps=10, warmup_steps=1)
    want = {key: 3 * n for key, n in _train_want(cfg, run).items()}
    want["selective_scan" if cfg.ssm is not None
         else "flash_attention"] += cfg.n_layers
    return want


def phase_paper_suite() -> dict:
    """The steps of ``benchmarks/run.py`` that no other phase runs, and
    the user-facing examples the card had not run, each through
    ``run.Suite.step`` on the card: ``fig2a`` and ``fig2b`` at the
    reference's arguments (fig2b: k 1-256, c_s 1/8/64, sim_len 1e7, the
    ``independent`` workload) and ``baseline_compare`` at its full grid
    cut to ``goldens.BASELINE_SIM_LEN``, against the JAX reference's
    digests; ``moe_balance`` on CPU-drawn inputs moved to the card,
    against the same call on the CPU (:func:`_moe_check`); the tiny-LM
    example's crash and resume (f32: K2's CUDA-core kernel and the f32
    backward), bit for bit an uninterrupted ``train`` of the same
    config; the quickstart on ``QUICKSTART_ARCHS``, its losses against
    its CPU run; ``roofline_report.render`` of phase ``shard``'s dry-run
    rows at their mesh.  The line is printed before a failed gate
    raises.  -> the launches of the examples and the runners (the
    comparison runs' excluded)."""
    import tempfile

    import torch
    from repro_torch.benchmarks import baseline_compare as BC
    from repro_torch.benchmarks import fig2a, fig2b
    from repro_torch.benchmarks import moe_balance as MB
    from repro_torch.benchmarks import roofline_report as RR
    from repro_torch.benchmarks import run as RUN
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import goldens as G
    from repro_torch.kernels import tlm_loop as TL
    from repro_torch.pytree import leaves, tree_map
    t_phase = time.perf_counter()
    suite, bad, path, out, tlm = RUN.Suite(), [], {}, {}, {}

    def step(name, fn, *args, **kw):
        before = TL.launches
        try:
            return _counted(path, suite.step, name, fn, *args, **kw)
        finally:
            tlm[name] = tlm.get(name, 0) + TL.launches - before

    # Fig. 2a, Fig. 2b and the headline comparison
    got = G.fig2a_digest(step("fig2a", fig2a.run, verbose=False,
                              device=SUITE_DEVICE))
    if got != G.FIG2A:
        bad.append(("fig2a", got))
    out["fig2b"] = G.fig2b_digest(step("fig2b", fig2b.run, verbose=False,
                                       device=SUITE_DEVICE))
    if out["fig2b"] != G.FIG2B:
        bad.append(("fig2b", out["fig2b"]))
    out["baseline"] = G.baseline_digest(step(
        "baseline_compare", BC.run, verbose=False, device=SUITE_DEVICE,
        sim_len=G.BASELINE_SIM_LEN))
    if out["baseline"] != G.BASELINE:
        bad.append(("baseline_compare", out["baseline"]))

    # moe_balance: the CPU's numbers on both devices, each run's expert
    # loads kept as the router gives them
    params, x = MB.inputs()
    apply, loads = MB.MOE.apply_moe, []

    def recorded(*args, **kw):
        y, aux = apply(*args, **kw)
        loads.append(aux["tokens_per_expert"].cpu().tolist())
        return y, aux
    MB.MOE.apply_moe = recorded
    try:
        card = step("moe_balance", MB.run, verbose=False, device=SUITE_DEVICE,
                    params=tree_map(lambda t: t.to(SUITE_DEVICE), params),
                    x=x.to(SUITE_DEVICE))
        cpu = MB.run(verbose=False, device="cpu", params=params, x=x)
    finally:
        MB.MOE.apply_moe = apply
    out["moe"] = _moe_check(card, cpu, loads, params, x)
    if not out["moe"]["ok"]:
        bad.append(("moe_balance", out["moe"]))

    # the tiny LM's crash and resume against an uninterrupted run
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        before = dict(path)
        calls, train, lines = step("train_tiny_lm", _tiny_lm, Path(tmp))
        lm_path = {key: n - before.get(key, 0) for key, n in path.items()}
    crash, resumed = calls
    cfg, run = crash["cfg"], crash["run"]
    keep = ("steps", "batch", "seq", "device")
    p_u, o_u, l_u = train(cfg, run, **{key: resumed["kw"][key]
                                       for key in keep},
                          verbose=lambda line: None)
    p_r, o_r, l_r = resumed["out"]
    start = int(crash["kw"]["fail_at"])
    steps = int(crash["kw"]["steps"])
    pairs = list(zip(leaves((p_r, o_r.mu, o_r.nu, o_r.step)),
                     leaves((p_u, o_u.mu, o_u.nu, o_u.step)), strict=True))
    unequal = sum(not (a.dtype == b.dtype and torch.equal(a, b))
                  for a, b in pairs)
    want = {key: n * steps for key, n in _train_want(cfg, run).items()}
    said = f"[train] resumed from step {start}"
    losses = [v for _, v in l_u]
    out["tiny_lm"] = {
        "params": cfg.param_count(), "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "dtype": run.param_dtype,
        "remat": run.remat, "args": list(TINY_LM_ARGS),
        "failure": crash.get("error"), "resumed_from": start,
        "leaves_compared": len(pairs), "leaves_unequal": unequal,
        "losses": l_u, "resumed_losses": l_r, "launches": lm_path,
        "want_launches": want, "lines": lines}
    if (crash.get("error") != f"injected failure at step {start}"
            or said not in lines or unequal
            or l_r != [(s, v) for s, v in l_u if s > start]
            or not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or lm_path != want):
        bad.append(("train_tiny_lm", {k: v for k, v in out["tiny_lm"].items()
                                      if k not in ("losses", "lines")}))
    del p_u, o_u, p_r, o_r, pairs, calls, crash, resumed
    torch.cuda.empty_cache()

    # the quickstart on the card against its CPU run from the card's
    # weights (``init_model`` draws on its device's generator)
    qs = _example("quickstart_torch")
    init = qs.MDL.init_model

    def card_init(*args, device=None, **kw):
        return tree_map(lambda t: t.cpu(),
                        init(*args, device=SUITE_DEVICE, **kw))
    out["quickstart"] = {}
    for name, arch in zip(("quickstart", "quickstart_ssm"),
                          QUICKSTART_ARCHS):
        before = dict(path)
        on_card = _quiet(qs.main)
        ids = step(name, on_card,
                   ["--arch", arch, "--device", SUITE_DEVICE])
        on_cpu = _quiet(qs.main)
        qs.MDL.init_model = card_init
        try:
            ids_cpu = on_cpu(["--arch", arch, "--device", "cpu"])
        finally:
            qs.MDL.init_model = init
        got, want_l = _losses(on_card.lines), _losses(on_cpu.lines)
        n = {key: c - before.get(key, 0) for key, c in path.items()}
        # the decode takes the argmax of the logits, padded_vocab wide
        vocab = reduced_config(get_config(arch)).padded_vocab
        row = out["quickstart"][arch] = {
            "losses": got, "losses_cpu": want_l, "decoded": ids,
            "decoded_equal_cpu": ids == ids_cpu, "launches": n,
            "want_launches": _quickstart_want(arch),
            "lines": on_card.lines}
        if (len(got) != 3 or len(want_l) != 3
                or not all(np.isfinite(got))
                or any(abs(a - b) > QUICKSTART_TOL * abs(b)
                       + QUICKSTART_PRINT_TOL for a, b in zip(got, want_l))
                or not all(0 <= i < vocab for i in ids)
                or f"forward: (2, 32, {vocab})" not in on_card.lines
                or n != row["want_launches"]):
            bad.append((name, {k: v for k, v in row.items()
                               if k != "lines"}))

    # the roofline table of phase shard's dry-run rows
    out["roofline"] = {}
    for file in SHARD_DRYRUNS:
        rows = json.loads((SHARD_OUT / file).read_text())
        mesh = rows[0]["mesh"]
        table = step("roofline_report", RR.render, str(SHARD_OUT / file),
                     mesh)
        cells = [line for line in table.splitlines()
                 if line.startswith("| ") and not line.startswith("| cell")]
        out["roofline"][file] = {"mesh": mesh, "rows": len(rows),
                                 "rendered": len(cells)}
        if (len(cells) != len(rows) or "SKIPPED" in table
                or any(r.get("status") != "ok" or r["mesh"] != mesh
                       for r in rows)
                or f"{len(rows)} cells" not in table.splitlines()[0]):
            bad.append(("roofline_report", file, table))
        out["roofline"][file]["table"] = table.splitlines()

    if path.get("hier_minsearch", 0):
        bad.append(("hier_minsearch launched", path["hier_minsearch"]))
    # fig2b's and the headline comparison's runs are the paper's program
    if not (tlm["fig2b"] and tlm["baseline_compare"]):
        bad.append(("tlm_loop launches", tlm))
    wall = time.perf_counter() - t_phase
    if wall > PAPER_SUITE_BUDGET_S:
        bad.append(("budget", wall, PAPER_SUITE_BUDGET_S))
    emit({"phase": "paper_suite", "ok": not bad, "failed": repr(bad),
          "fig2a": G.FIG2A, "fig2b": out["fig2b"],
          "fig2b_args": {"ks": list(fig2b.KS), "c_s": [1.0, 8.0, 64.0],
                         "sim_len": 1e7},
          "baseline_compare": out["baseline"],
          "baseline_args": {"ks": list(BC.KS),
                            "pair_periods": list(BC.PAIR_PERIODS),
                            "seeds": list(BC.SEEDS),
                            "sim_len": G.BASELINE_SIM_LEN,
                            "cut_from": 2e6, "cut": "horizon only"},
          "moe_balance": out["moe"], "tiny_lm": out["tiny_lm"],
          "quickstart": out["quickstart"], "roofline": out["roofline"],
          "launches": path, "tlm_loop_launches": tlm,
          "walls_s": dict(suite.walls), "wall_s": wall,
          "budget_s": PAPER_SUITE_BUDGET_S})
    if bad:
        raise AssertionError(f"paper_suite: gates failed {bad}")
    return dict(path, tlm_loop=sum(tlm.values()))


# --------------------------------------------------------------------------
# The paper's runners at the reference's own horizons
# --------------------------------------------------------------------------

PAPER_FULL_BUDGET_S = 60.0     # the phase's share of TIME_LIMIT_S
# each runner's horizon: the reference's default (fig3a, fig3b, table5
# 4e6, baseline_compare 2e6), uncut; a cut would be named here and in the
# phase's line
PAPER_FULL_SIM_LEN = {"fig3a": 4e6, "fig3b": 4e6, "table5": 4e6,
                      "baseline_compare": 2e6}


def phase_paper_full() -> int:
    """The paper's Fig. 3a, Fig. 3b, Table 5 and headline comparison
    (``baseline_compare``) at the reference's own arguments, full grids
    and horizons, each through ``run.Suite.step`` on the card: each
    payload's rows digest and claims equal to the reference runner's on
    the CPU at the same arguments (``goldens.PAPER_FULL``), each k group
    one ``tlm_loop`` launch.  The line is printed before a failed gate
    raises.  Returns the launches."""
    from repro_torch.benchmarks import baseline_compare, fig3a, fig3b
    from repro_torch.benchmarks import run as RUN
    from repro_torch.benchmarks import table5
    from repro_torch.core import goldens as G
    from repro_torch.kernels import tlm_loop as TL
    t_phase = time.perf_counter()
    suite, bad, rows, launches = RUN.Suite(), [], {}, 0
    runners = {"fig3a": (fig3a, fig3a.KS), "fig3b": (fig3b, fig3b.KS),
               "table5": (table5, tuple(table5.PAPER)),
               "baseline_compare": (baseline_compare, baseline_compare.KS)}
    for name in G.PAPER_FULL_RUNNERS:
        mod, ks = runners[name]
        before = TL.launches
        payload = suite.step(name, mod.run, verbose=False,
                             sim_len=PAPER_FULL_SIM_LEN[name],
                             device=SUITE_DEVICE)
        n = TL.launches - before
        launches += n
        got = G.paper_full_digest(payload)
        rows[name] = dict(got, sim_len=PAPER_FULL_SIM_LEN[name],
                          ks=list(ks), launches=n,
                          wall_s=suite.walls[-1][1],
                          match=got == G.PAPER_FULL[name])
        if got != G.PAPER_FULL[name] or n != len(ks):
            bad.append((name, got, n))
    wall = time.perf_counter() - t_phase
    if wall > PAPER_FULL_BUDGET_S:
        bad.append(("budget", wall, PAPER_FULL_BUDGET_S))
    emit({"phase": "paper_full", "ok": not bad, "failed": repr(bad),
          "runners": rows, "cuts": {}, "launches": launches,
          "wall_s": wall, "budget_s": PAPER_FULL_BUDGET_S})
    if bad:
        raise AssertionError(f"paper_full: gates failed {bad}")
    return launches


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hier_minsearch as HM
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.kernels import tlm_loop as TL

    t_script, seconds = time.perf_counter(), {}

    def timed(phase, *args):
        """Run one phase, keeping its seconds for the summary line."""
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__.removeprefix("phase_")] = \
            time.perf_counter() - t0
        return out

    smi = timed(phase_device)
    k3_bwd_build = timed(phase_build)
    k1 = timed(phase_k1)
    k2 = timed(phase_k2)
    k3, k3_states = timed(phase_k3)
    tlm = {}                                      # tlm_loop's, a path

    def tlm_path(name, want=None):
        """Read the tlm_loop launches of the path that just ended:
        ``want`` None means more than 0 (the paper's program), else
        exactly ``want`` (0: a path of the host loop alone)."""
        n = tlm[name] = TL.launches
        if (n == 0) if want is None else (n != want):
            raise AssertionError(f"the {name} path launched tlm_loop {n} "
                                 f"times, want "
                                 f"{'> 0' if want is None else want}")
        TL.launches = 0

    TL.launches = 0                               # the golden path starts
    timed(phase_golden)
    tlm_path("golden")                            # ... and ends here
    FA.launches = SS.launches = HM.launches = 0   # the TLM path starts
    paper_off = timed(phase_paper)
    paper_eps = paper_off["events"] / paper_off["wall_s"]
    timed(phase_mapper)
    tlm_launches = HM.launches                    # ... and ends here
    if tlm_launches == 0:
        raise AssertionError("the TLM path never launched hier_minsearch")
    tlm_path("paper", 1)
    tlm_row = timed(phase_tlm_device)             # the device loop's check
    tlm_path("tlm_device", 2 * len(TLM_DEVICE_GROUPS))   # two runs a group
    events, lines, profile_off = timed(phase_profile)
    tlm_path("profile", 0)                        # the host loop alone
    tlm_path("syncs", timed(phase_syncs, events, lines))
    FA.launches = SS.launches = HM.launches = 0   # the sweep path starts
    golden = timed(phase_sweep)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the sweep path (no kernel of its own but "
                             "tlm_loop) launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("sweep")
    FA.launches = SS.launches = HM.launches = 0   # the fabric path starts
    linear = timed(phase_fabrics)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the fabric path (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("fabrics", 0)
    FA.launches = SS.launches = HM.launches = 0   # the queue path starts
    timed(phase_queues, linear)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the queue path (no kernel of its own but "
                             "tlm_loop's k=1 group) launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("queues", 1)
    FA.launches = SS.launches = HM.launches = 0   # the fault path starts
    timed(phase_faults, linear)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the fault path (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("faults", 0)
    FA.launches = SS.launches = HM.launches = 0   # the trace path starts
    timed(phase_trace, profile_off, linear)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the trace path (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("trace", 0)
    del paper_off, profile_off, linear
    FA.launches = SS.launches = HM.launches = 0   # the replay path starts
    replay_k1 = timed(phase_replay)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, replay_k1):
        raise AssertionError("the replay path launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("replay", 0)
    timed(phase_lm_small)
    prefill = timed(phase_lm_prefill)
    timed(phase_lm_serve)
    k2_bwd = timed(phase_k2_bwd)
    k3_bwd = timed(phase_k3_bwd, k3_bwd_build)
    timed(phase_lm_train_small)
    trained, lm_train = timed(phase_lm_train)
    trained_ssm, lm_train_ssm = timed(phase_lm_train_ssm)
    trained_moe = timed(phase_lm_train_moe)
    # the CLIs of phase lm_resume in subprocesses, beside phases
    # lm_train_remat to lm_resume (their steps wait on the card)
    with tempfile.TemporaryDirectory() as cli_dir, \
            ThreadPoolExecutor(1) as pool:
        cli = pool.submit(_cli_pair_and_serve, Path(cli_dir) / "cli")
        remat_runs, mb2_row = timed(phase_lm_train_remat, lm_train,
                                    lm_train_ssm)
        accum_runs = timed(phase_lm_train_accum, lm_train, mb2_row)
        resumed = timed(phase_lm_resume, cli)
    families = timed(phase_lm_families)
    sharded = timed(phase_shard, smi)
    FA.launches = SS.launches = HM.launches = 0   # the copy check starts
    TL.launches = 0
    timed(phase_loop_copy)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, 0):
        raise AssertionError("the loop-copy check (no kernel of its own) "
                             "launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("loop_copy", 0)
    FA.launches = SS.launches = HM.launches = 0   # the suite starts
    suite_launches, suite_tlm = timed(phase_suite, golden, paper_eps)
    if (FA.launches, SS.launches, HM.launches) != (0, 0, suite_launches):
        raise AssertionError("the suite launched "
                             f"{(FA.launches, SS.launches, HM.launches)}")
    tlm_path("suite", sum(suite_tlm.values()))
    del golden
    FA.launches = FA.bwd_launches = SS.launches = 0   # the paper suite's
    SS.states_launches = SS.bwd_launches = HM.launches = 0   # path starts
    # ... each step's launches read around it (phase paper_suite)
    paper_suite = timed(phase_paper_suite)
    tlm_path("paper_suite", paper_suite["tlm_loop"])
    tlm_path("paper_full", timed(phase_paper_full))
    # K2's row also covers its forward at the training shape (phase k2_bwd)
    k2["max_abs_err"] = max(k2["max_abs_err"],
                            k2_bwd.pop("k2_out_max_abs_err"))
    emit({"phase_seconds": seconds,
          "script_s": time.perf_counter() - t_script})
    emit({"tlm_loop_launches": tlm})
    # K2 runs on the prefill, olmo_1b's and deepseek_moe_16b's training
    # (under every remat policy, microbatches, int8 and the resume), the
    # last five families' prefills and trainings (with its backward) and
    # the paper suite's examples (the tiny LM in f32, the quickstart), K3
    # on the prefill, the SSM quickstart's forward, and its training
    # variant on falcon_mamba_7b's training (remat full, none and dots)
    # and the SSM quickstart's
    trains = (trained, trained_ssm, trained_moe, *remat_runs, *accum_runs,
              resumed, paper_suite)
    rows = [(HM.NAME, HM.SOURCE, HM.REPLACES,
             tlm_launches + replay_k1 + suite_launches
             + paper_suite["hier_minsearch"], k1),
            (FA.NAME, FA.SOURCE, FA.REPLACES, prefill["flash_attention"]
             + sum(t["flash_attention"] for t in trains)
             + families["flash_attention"] + sharded["flash_attention"], k2),
            (SS.NAME, SS.SOURCE, SS.REPLACES, prefill["selective_scan"]
             + sum(t["selective_scan"] for t in trains), k3),
            (SS.STATES_NAME, SS.SOURCE, SS.REPLACES,
             sum(t["selective_scan_states"] for t in trains), k3_states),
            (FA.BWD_NAME, FA.BWD_SOURCE, FA.BWD_REPLACES,
             sum(t["flash_attention_bwd"] for t in trains)
             + families["flash_attention_bwd"]
             + sharded["flash_attention_bwd"], k2_bwd),
            (SS.BWD_NAME, SS.BWD_SOURCE, SS.BWD_REPLACES,
             sum(t["selective_scan_bwd"] for t in trains), k3_bwd),
            (TL.NAME, TL.SOURCE, TL.REPLACES, sum(tlm.values()), tlm_row)]
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": n,
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m.get("library_ms")}
        for name, source, replaces, n, m in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
