#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--out FILE] [--only K1,K2]

Phases, each printed as one JSON line (`--only` runs device, build and the
named phases, and prints neither the kernels line nor the result):

1. device  -- the card (`nvidia-smi` name and power limit); no CUDA device
              means exit 1 at once, with no result.
2. build   -- nvcc builds every kernel of `factorvae_tpu_torch/csrc/` for
              sm_90a, in parallel; the build seconds and ptxas reports.
3. K1      -- the GRU forward kernel, its serving and its residual
              (training) variant, against the plain PyTorch version on the
              card: the flagship serving chunk (N = 32 days x 304 stocks,
              T = 20, H = 64), one flagship training day (304 x 20 x 64), the
              alpha360-k60 shape (304 x 60 x 60) and ragged shapes with H = 60
              and H = 37; bitwise repeats, and the residual variant's h
              bitwise the serving variant's. At the first three shapes:
              kernel, plain and cuDNN nn.GRU times (nn.GRU on xi with an
              identity input weight, checked against the plain version)
              and the bound.
4. K4      -- the K-head attention kernel against its plain version at
              B = 32, N = 304, K = 96, H = 64, with padded rows, an
              all-masked day, NaN, +inf and -inf latent rows (the guard; the
              infinite ones where the folded score would be -inf) and a
              keep-mask, and at the csi800-k60 width (N = 800, H = 60) and
              H = 37; the days that took the exact path must be the
              poisoned ones; times and bounds at B = 32 and at one training
              day (B = 1); the launch rule's heads per CTA.
5. slice   -- a flagship-width FactorVAE (C158/T20/H64/K96/M128, random
              weights from --seed) on an 80-day synthetic panel of 300
              stocks (padded to 304), admitted to the port's ModelRegistry;
              the ScoringDaemon answers a day with `top`, a 34-day range
              (the last chunk is -1-padded), ping and stats. The launch
              counters are set to 0 just before this tick: K1's serving
              variant and K4 must be above 0 after it, K1's residual
              variant and every backward kernel at 0. The same days are
              scored on the CPU, where the plain versions run, and compared.
6. K2      -- the GRU backward (K2, and K3's T > 24 case) against its plain
              version for dxi, dWh and db: gru_bwd alone (its own residual
              forward, the walk, the dWh kernel), the walk from given
              residuals, and the dWh kernel alone, at one flagship training
              day (304 x 20 x 64), 8 days (2432 rows), the alpha360-k60
              shape (T = 60, H = 60) and H = 37 with a ragged tile; bitwise
              repeats. At one day and at the alpha360-k60 shape: kernel,
              plain and cuDNN nn.GRU backward times and the bound; the pair
              (residual forward + walk, what a training step runs) against
              cuDNN's forward + backward; the dWh kernel against
              torch.matmul.
7. K5      -- the attention backward kernel against its plain version at
              B = 1 and 8, N = 304, K = 96, H = 64 with padded rows, an
              all-masked day, NaN, +inf and -inf latent rows (their days get
              zero gradient; the exact path must run on them and on no other
              day) and a keep-mask; csi800-k60 width (N = 800, H = 60) and
              H = 37; a bitwise repeat; kernel and plain times and bounds at
              one and at 8 clean days, and at the 8 poisoned days (three of
              them on the exact path).
8. train   -- Trainer.fit for one epoch of the flagship preset
              (days_per_step = 1) on the 80-day panel: 50 train days, 20
              validation days. Every launch counter is set to 0 just before
              the fit and must be above 0 after it: K1's residual variant,
              the walk and the dWh kernel once per train step, K1's serving
              variant once per validation batch; every loss finite. The same
              run with dropout_rate = 0 and recon_loss = "nll" takes its
              first 8 steps on the card and on the CPU from the same
              weights: per-step losses and the parameters after 8 steps are
              compared. CUDA-event times of one step's stages.
9. precision -- the precision ladder at flagship width on the same 80-day
              panel: the kernels' one hidden-size limit (`ops.kernels.
              MAX_HIDDEN`) against every built library's `*_max_hidden()`;
              K1 on bf16 inputs bitwise K1 on their f32 upcast; a bfloat16
              32-day chunk, card against CPU (per-day Spearman >= 0.99), with
              its stages' times, the upcast of xi for K1 as a stage of its
              own, and the projections' bound; int8 weight-only scores, card
              against CPU (max abs <= 1e-5), and the parameter bytes of the
              float32 and int8 rungs; the chunk's time at each rung; one mixed
              epoch (bfloat16 over float32 masters, the dynamic loss scale)
              with every launch counter set to 0 just before it: K1's
              residual variant, the walk, dWh and K5 once per step, the
              masters and Adam's moments float32, the skipped steps within
              the rollback's budget; the loss scale and the epoch's time.
10. cli    -- the experiment CLI (`factorvae_tpu_torch.cli.main`) in this
              process at flagship width, f32, on a reference-schema pickle of
              a 120-day synthetic panel of 300 stocks: 50 train days, 20
              validation days, 50 scored days. Runs, each with every launch
              counter set to 0 just before it: (a) 3 epochs with
              --deterministic_scores --backtest; (b) --resume to 4 epochs,
              which must start at epoch 3; (c) --score_only, which must give
              (b)'s RankIC; (d) --score_only --device cpu on the first 8
              scored days, held against (c)'s CSV, and both CSVs of those
              days through `python -m factorvae_tpu_torch.eval.compare` (the
              CPU's as the reference): exit 0, the Rank-IC delta within
              0.002; (e) a fresh --save_dir
              under a chaos plan (`chaos.active`) poisoning epochs 1 and 2 of
              4 with nan_grads: the trail
              must be epochs 0, 1, 2, 1, 2, 3 with one rollback to epoch 0 at
              half the lr; (f) a fresh --save_dir with --bf16 --int8_scores,
              one mixed epoch and the int8 scores (dequantized to bf16):
              finite losses, a loss scale, one launch of K1's residual
              variant, the walk and dWh per step, and of K1's serving variant
              per validation batch and scoring chunk, a finite CSV and
              RankIC. (a) must launch K1's residual variant, the walk
              and the dWh kernel once per train step, K1's serving variant
              once per validation batch and scoring chunk, K4 once per
              forward and K5 once per train step; (c) the serving variant
              and K4 only. The CSV has one row per valid (day, stock) and
              the RankIC is finite. Epoch, scoring and CSV times. The
              native panel ops' counters (`native.call_counts()`) are set to
              0 just before (a): its panel build and its fill maps must be
              served by the native pass (native above 0, numpy at 0); then
              the pickle's `build_panel` and the padded panel's
              `compute_fill_maps` with the native pass and with
              FACTORVAE_NATIVE=0, bitwise equal, each timed.
11. fleet  -- fleets of models at flagship width, f32, S = 4 lanes: (a)
              K1 (both variants), the walk and dWh at one training day and
              at T = 60 / H = 60 (K3's case), K4 and K5 at one training day
              per lane, each with four weight sets, against the lane-axis
              plain versions, each lane bitwise the one-lane launch of the
              same launch shape, and a NaN in lane 2 leaving lanes 0, 1 and
              3 bitwise as they were (the attention's exact path on lane 2's
              day alone); times at four lanes beside four one-lane times,
              bounds four times the one lane's; (b) FleetTrainer, a seed
              fleet of four, one epoch on the 80-day panel with every launch
              counter set to 0 just before it: each training kernel once per
              fleet step, K1's serving variant once per validation batch;
              each lane's losses against the solo Trainer of its seed on the
              card, the fleet epoch's wall against the solo epoch's, and the
              busy share of five steps of each; (c) the CLI on the 120-day
              pickle, one epoch each: --fleet_seeds 3 --backtest (one
              launch per fleet step), --score_only on the winning seed (the
              same RankIC), and a 2 x 2 lr:kl_weight --hyper_grid; (d) a
              one-lane fleet equal to Trainer.fit bitwise on the card.
12. stream -- the stream residency at flagship width on the 80-day panel,
              stream_chunk_days = 16 (train chunks of 16, 16, 16 and 2
              steps), every result held bitwise against the "hbm"
              residency's: (a) Trainer.fit, one epoch from the same init,
              parameters and history, every launch counter set to 0 just
              before each fit (each training kernel once per step, K1's
              serving variant once per validation batch), the train and
              validation ledgers, cold and warm epoch walls; (b)
              predict_panel over 50 days, deterministic, sampled and int8,
              and predict_panel_fleet at S = 4 lanes; (c) FleetTrainer, S =
              4, one epoch, per lane; (d) stream_fail on chunk 1 (one retry,
              the same scores) and a 50 ms stream_stall on chunk 0 (the
              consumer's wait rises by it); (e) the peak device memory of a
              stream scoring pass over the whole 80-day panel and over a
              3,000-day x 300-stock one (580 MB on the host): equal within
              16 MiB, both below the hbm dataset's peak on the 3,000-day
              panel; the time per 32-day chunk of both residencies there;
              (f) a PanelStore of 75 days, an append of 5 (the round trip
              exact), extend_days under both residencies and the daemon's
              extend_dataset: the new days' scores bitwise a fresh
              dataset's; (g) the CLI with --panel_residency stream: the
              hbm run's CSV byte for byte; (h) 10 consumptions of an
              8-chunk stream of 4 MB chunks whose consumer spins ~100 ms on
              the device per chunk: every chunk read intact, the peak of
              device memory at least two chunks and below three each time
              (a chunk's slot is freed when its last tensor goes). Each
              ledger: bytes_put,
              produce_seconds, wait_seconds, copy_seconds (CUDA events),
              h2d_gb_per_s, staging_waits, retries, overlap_frac.
13. serve  -- the full scoring daemon at flagship width on the 80-day panel:
              (a) eight f32 models, two bf16 and two int8, warmed; (b) one
              tick per rung of the same 32 days, with every launch counter
              set to 0 just before the three ticks: one fused dispatch per
              bucket, K1's serving variant and K4 once each per bucket (3 in
              all) and nothing else, each launch's output within K1_TOL /
              K4_TOL of the kernel's plain version on the inputs that launch
              got, each lane within 1e-5 (relative) of its serial scores and
              of the same tick on the CPU (bf16 lanes: per-day Spearman >=
              0.99 against the CPU), no fused_fallback mark; the fused tick
              against S serial ticks at S = 2, 4, 8, split by the timeline's
              spans into dispatch, responses and the rest, a re-stacking
              tick, the device time of a 2-lane, an 8-lane and a one-model
              tick by kernel kind (torch.profiler), single-day and 34-day
              latency p50/p99/max over 500 requests each; (c) a
              50 ms serve_stall against deadline_ms 20: two misses, the
              breaker open, a fast-fail with retry_after_s, the half-open
              probe closing it, health ok -> degraded -> ok; (d) a budget of
              4 of 6 weights directories: two LRU evictions, a cold start
              bitwise the scores before its eviction, serve_cold_fail
              healed by one retry; (e) POST /admit of a candidate on 5
              holdout days to serve_http with a TickScheduler while four
              keep-alive clients send single-day requests: every request
              answered, requests answered while the admission ran (it runs
              on the scheduler's admission thread, not the tick thread), the
              longest wait any client saw, each client's answers flipping
              once from the incumbent to the candidate, every answer's
              scores its model's; (f) serve_http with a TickScheduler and 8
              keep-alive clients of 150 single-day requests: requests/s,
              p50/p99/max, a /metrics scrape, /healthz 200; (g) `python -m factorvae_tpu_torch.serve --batch`
              as a subprocess, equal to in-process serve_batch_file.
14. pool   -- the serving fleet at flagship width on the 80-day panel,
              f32 unless stated: (a) one model's weights exported on the
              CPU as an f32 and an int8 AOT artifact (`torch.export`), loaded
              on the card and admitted to a ModelRegistry; a 32-day request
              to each with every launch counter set to 0 just before it: K1's
              serving variant and K4 32 times each (one exported call per
              day), nothing else, each launch within K1_TOL / K4_TOL of the
              kernel's plain version on its inputs; the scores within
              POOL_TOL (relative) of the in-process path (f32, and the int8
              rung) and of the artifact on the CPU; sizes, export seconds,
              load ms, and the 32-day and one-day latency of both paths; (b)
              the fleet's CLI (`--workers 2 --router_port`) over four
              weights directories, as a subprocess: its router's process
              without a CUDA context, worker 1's /metrics compile 0 and
              compile_cached >= 2, four 32-day requests routed within
              POOL_TOL of the in-process scores, the workers' own launch
              counters (`/stats`) before and after them (K1's serving variant
              and K4 only), sticky owners, /stats with both workers' scrape
              URLs, the merged /metrics with one HELP/TYPE per family, each
              worker's reserved device memory, and (with --metrics_jsonl on
              the router and its workers) `obs.collect.collect_fleet` over
              the router: the three streams merged on the router's clock by
              the pool's clock probes, every worker span of a routed request
              inside its router_forward span up to half the probe's round
              trip, each worker's offset and round trip; SIGTERM reaping
              every worker;
              (c) 8 keep-alive clients x 75 single-day requests through the
              router at 1, 2 and 4 workers, and the same load on one daemon
              (`--http --scheduler`): requests/s, p50/p99/max, reserved
              memory per process; (d) a pool of 2 over the store's artifacts
              under 4 clients: kill_worker on worker 1, no request failed,
              its keys rerouted, the respawn from the store on its port, its
              scores bitwise those before the kill, the MTTR; (e) admit
              fan-out (a bootstrap, then a flip under 4 clients whose answers
              flip once), scale_up to 3 and scale_down to 2, a launch_remote
              join (downloads sha-verified, registered with the store's
              digest, scores bitwise worker 0's), kill_remote_worker and the
              re-join, POST /upgrade with zero failed requests under 4
              clients, and a hedged forward past a 1 s serve_stall on the
              owner (two daemons on the card behind a router): the second
              answer wins, counted once.
15. stacked -- the stacked GRU at flagship width, gru_layers = 2, on the
              80-day panel: (a) the extractor's latent of one training day
              and one deterministic training step (dropout 0, nll) on the
              card against the same on the CPU from the same weights, at the
              train phase's limits (latent and loss TRAIN_LOSS_RTOL, each
              parameter's gradient TRAIN_GRAD_RTOL); (b) the launches of a
              no-grad forward (K1's serving variant once, for the top layer)
              and of the step (K1's residual variant, the walk, dWh, K4 and
              K5 once each, whatever L is); (c) a warm L = 2 epoch against a
              warm L = 1 epoch, with every launch counter set to 0 just
              before the L = 2 one (each training kernel once per step, K1's
              serving variant once per validation batch).
16. wf     -- the walk-forward refit at flagship width, 300 stocks: (a) in
              this process, a PanelStore seeded with 120 synthetic days
              (22.9 MB of f32), a stream-resident dataset, the daemon behind
              serve_http with a TickScheduler and 4 keep-alive clients
              scoring the newest day throughout; the bootstrap (one epoch),
              then one cycle of 2 new days with every launch counter set to
              0 just before it: every kernel launched, no request failed,
              each stage's seconds, one K1 and one K4 launch of the judge
              stage against their plain versions (K1_TOL / K4_TOL), the
              refit's weights bitwise a plain warm_refit on the card from
              the same warm weights; (b) the refit's seconds blocked in
              Checkpointer.save with async against sync saves (3 epochs
              each), and the sha256 seconds per manifest; (c)
              corrupt_checkpoint on the newest epoch (restore falls back a
              step and quarantines it) and corrupt_artifact on the promoted
              weights (register_checkpoint refuses them); (d) `python -m
              factorvae_tpu_torch.wf` as a subprocess: a clean cycle, then
              kill_mid_refit (FACTORVAE_CHAOS) killing the second, then the
              re-run resuming it, against a never-killed run: the refit's
              weights.pt and the store's slabs byte-identical, the seconds
              to resume.
17. obs    -- the run observatory at flagship width, f32, on the 80-day
              panel: (a) the probes: one deterministic step (dropout 0, nll)
              with obs_probes on the card and on the CPU from the same
              weights (each probe within OBS_STEP_RTOL, the non-finite counts
              equal); warm epochs with probes off and on from the same init,
              ABAB x3 (weights and losses bitwise, the walls' medians: the
              probes' cost); a nan_grads epoch (nonfinite_grads > 0,
              update_norm_mean NaN, obs.report's nonfinite flag, the
              rollback); a seed fleet of four with probes, each lane within
              OBS_LANE_RTOL of its seed's solo run; (b) a PROFILE_REQUEST
              before epoch 1 of a run with a metrics stream, with every
              launch counter set to 0 just before that epoch: its
              profile_capture record (files >= 1, total_us > 0, no error),
              the capture's kernels by CUDA function (K1's residual variant,
              the walk, dWh, K4, K5) counted equal to the launch counters'
              rise over the train epoch, less the kernel records CUPTI lost
              (matched to their launch calls by correlation id; the
              capture's other lost records reported), and each wrapper's
              host ranges
              equal to its counter; device us per launch, and the busy
              share (capture device time over the train_epoch span) beside
              `_busy_share`'s reading of 5 probed steps; (c) the CLI with
              --obs --prom_textfile --profile on a stream-resident panel:
              the .prom file of the last epoch, `python -m
              factorvae_tpu_torch.utils.trace_summary` exiting 0 with the
              kernels listed, no report flag, the device, stream and
              checkpoint lanes with their overlap_frac, then a --debug_nans
              run; (d) the daemon's POST /profile start and stop around
              single-day and 34-day requests on serve_http with a
              TickScheduler, a warm-up request first: the answer's K1
              serving and K4 rows, and the kernels after the warm-up counted
              equal to the launch counters (as in (b)), and whether the tick
              thread's
              CPU rows were captured; (e) the perf ledger
              (`obs/ledger.py`) on a temp history: two rows of (a)'s warm
              epochs (probes off, train windows/s) made on the card, with a
              CPU-rig row between them, then `ledger.check`: the card's
              latest row compared with the card's first (history 2, one
              other-rig row skipped), both rows naming the card and its
              power limit as nvidia-smi gives them.
18. remat  -- rematerialized training at flagship width on the 80-day
              panel: (a) one step from the same init under train.remat
              "none", "dots" and "full" at days_per_step 1 and 8 (the
              preset's dropout and mse, the noise drawn before the
              checkpoint), every launch counter set to 0 just before each:
              K1's residual variant and K4 twice under "dots" and "full"
              (forward and recompute), once under "none", the walk, dWh and
              K5 once; the loss, aux, every gradient and the generator's
              state against "none" (bitwise, or within TRAIN_LOSS_RTOL /
              TRAIN_GRAD_RTOL, the generator bitwise); the peak device
              memory a second step adds (torch.cuda.max_memory_allocated,
              reset before it) and the memory a forward holds for its
              backward; a deterministic "full" step on the same days at
              each days_per_step, card against CPU, at the train phase's
              limits (zero-gradient parameters and key-bias rows set apart
              as there; a bias whose rows cancel its gradient held to
              SUM_RTOL of its terms); (b) step ms per rung and
              days_per_step, ABC CBA rounds, medians; (c) a mixed (bf16)
              step under "dots" against "none"; (d) a seed fleet of four,
              one epoch under "full" against "none" (parameters within
              TRAIN_PARAM_ATOL); (e) one warm Trainer epoch per rung, every
              launch counter set to 0 just before it; the "full" epoch's
              launches: K1's residual variant and K4 twice per step, the
              walk, dWh and K5 once, K1's serving variant and K4 once per
              validation batch.
19. factors -- `eval.factors.decompose` at flagship width over a 34-day
              range of the 80-day panel (two 32-day chunks), every launch
              counter set to 0 just before it: K1's serving variant and K4
              once per chunk, nothing else; the factors, exposures and loss
              frames' shapes and finiteness; the same range on the CPU
              (factors, exposures and the KL within FACTORS_TOL); ms per
              32-day chunk.
20. plan    -- the execution planner: (a) `python -m
              factorvae_tpu_torch.autotune --config flagship --fleet --hyper
              --stream --serve --train_precision --remat` (its default
              --days 8 --reps 2) into a temporary table, in this process,
              then the train race alone for alpha360-k60 (T = 60: K3's walk);
              every race must hold its default candidate, every kernel must
              launch in the flagship races, and the training kernels and K4
              in the alpha360-k60 race; (b) `cli --auto_plan` on a 60-day
              pickle of 300 stocks against that table: the `plan` record is
              the 300-stock row's, the trained days_per_step, dtype and pad
              (300) are the row's, and the scores CSV is byte for byte that
              of a run given the same knobs as flags; (c) `cli
              --compile_cache DIR` in two fresh processes: the first compiles
              the four libraries into DIR, the second loads all four as
              compile_cached and compiles none; DIR then holds those four
              and the native panel ops' library (outside the counts); (d) `serve --precision plan`
              (HTTP, --scheduler) against the row with a bfloat16 serve
              block: admitted at bfloat16, the tick and batch the row's, and
              the fleet's SLO and hedge the row's; (e) flagship scores at the
              plan's pad (300) against pad_multiple 8's 304, within SLICE_TOL.
21. mesh    -- parallelism on torch.distributed at flagship width
              (C158/T20/H64/K96/M128) on the 80-day panel of 300 stocks
              padded to 300, days_per_step 2, MESH_STEPS updates of the
              epoch-0 order from the seed's weights, every launch counter set
              to 0 just before each run. The serial run on the card is the
              reference. (a) This process joins an NCCL group of one rank (an
              all-reduce over it leaves its tensor as it was); the 1 x 1
              mesh's updates are bitwise the serial ones. (b) Two spawned
              ranks share the card over gloo and run the 2 x 1 and the 1 x 2
              mesh: on every rank K1's residual variant, the walk, dWh, K4
              and K5 launch; K1 is given 300 rows a launch (one day of 300
              stocks on 2 x 1, two days of 150 on 1 x 2); the ranks'
              parameters agree bitwise; the first update's gradients and
              parameters and every step's loss are within the CPU tests'
              tolerances of the serial run's (MESH_TOL, GRU_MESH_TOL,
              MESH_LOSS_RTOL); the 1 x 2 scores of MESH_SCORE_DAYS days
              (`predict_panel(mesh=)`) within MESH_TOL of serial scoring.
              Each run's step walls and `comms` block (collective calls and
              payload bytes by kind and axis, `obs/comms.py`). (c) The same
              two ranks train fleets, one epoch a generation, each against
              the same run without a mesh on the card: a 2-lane hyper-fleet
              (lr, kl_weight per lane) on 2 x 1, one lane a rank; a 4-lane
              PBT of 2 generations on 2 x 1; a 2-seed fleet on 'host' 2 x
              'data' 1 x 'stock' 1 (each update's days split over 'host').
              The ranks agree bitwise on every shared leaf (the gathered
              final and best parameters, best_val, the records, PBT's
              generations and scalars); lane parameters within the
              card's fleet tolerance, TRAIN_PARAM_ATOL (the elements where
              Adam turns rounding into steps within lr a step, counted,
              and the count beyond the CPU tests' MESH_FLEET_TOL); the
              losses within
              MESH_LOSS_RTOL; PBT's winners, exploited lanes and scalars
              equal. Every rank launches K1's residual variant, the walk,
              dWh, K4 and K5 in every run; each run's launches per rank,
              walls and comms block. (d) In (a)'s NCCL group of one,
              `autotune --mesh` at csi300-k60 width (one row, 300 stocks)
              into a temporary table:
              the 1 x 1 mesh against no mesh at the train winner's
              days_per_step, each candidate's seconds per trained day and
              the verdict. Two ranks on one card check the mesh paths;
              they measure no scaling.
22. wide    -- hidden sizes above 64 (the kernels' H <= 128 and <= 256
              instances): at H = 128 and 256, each kernel against its plain
              version on the card, forward and every gradient (K1 at a
              32-day chunk, one training day and T = 60; the walk and dWh
              at one day and at T = 60, K3's case; K4 over 32 days and K5
              over 8 with an all-masked day and NaN, +inf and -inf days,
              which must be exactly the days of the exact path, with and
              without a keep-mask), bitwise repeats, within the K phases'
              limits; the wide walk (persistent clusters) at every shape
              it takes, one day and T = 60, each tile bitwise the rule's
              pick at its cluster, two lanes each bitwise its one-lane
              launch, a NaN in Wh, dh or a residual (and in hseq for dWh)
              where the plain version has it; their times beside the plain
              versions', cuDNN's nn.GRU forward and backward at the same
              H, the walk alone and dWh beside torch.matmul(hseq^T, dg),
              and the bounds. Then the entry points at the flagship's widths
              (C158/T20/K96/M128, a 60-day pickle of 300 stocks) at each
              H, every launch counter set to 0 just before each: (a) `cli
              --hidden_size H` trains one epoch (30 steps; K1's residual
              variant, the walk, dWh and K5 once per step, K1's serving
              variant once per validation batch and scoring chunk, K4 once
              per forward), scores and writes the CSV and its Rank-IC; (b)
              the daemon admits (a)'s best weights and answers a one-day
              and a 34-day request in one tick (K1's serving variant and K4
              only), the day and two days of the range within SLICE_TOL of
              the CPU's scores; (c) `grid_sweep` over hidden_size {64, 128,
              256} x lr {1e-4, 3e-4}: three shape buckets, each a 2-lane
              hyper-fleet, each training kernel once per fleet step.
23. kernels -- one line {"kernels": [...]} with each kernel's error, times,
              bound and launches (in the train phase; `launches_serving` in
              the slice phase, `launches_cli` in the CLI's run (a),
              `launches_mixed` in the precision phase's mixed epoch,
              `launches_fleet` in the fleet epoch, `launches_stream` in
              the stream phase's stream epoch, `launches_serve` in the
              serve phase's fused ticks, `launches_artifact` in the pool
              phase's f32 artifact request, `launches_pool` in the
              fleet's workers for its routed requests, `launches_stacked`
              in the stacked phase's L = 2 epoch, `launches_wf` in the wf
              phase's in-process cycle, `launches_obs` in the obs phase's
              profiled epoch, `launches_remat` in the remat phase's "full"
              epoch, `launches_factors` in the factors phase's range,
              `launches_plan` in the plan phase's races, `launches_mesh`
              in the mesh phase's 1 x 2 run, on rank 0, and
              `launches_mesh_fleets` in its (c) fleets, per rank),
              the obs phase's `profiler_us_per_launch`
              beside `graph_ms`, and its `fleet_*` times
              at four lanes (`fleet_ms`, `fleet_graph_ms`, `fleet_solo_x4_ms`,
              `fleet_bound_ms`, ...); then the wide phase's rows, named
              "<kernel> (H=128)" and "(H=256)", whose `launches` are that
              H's CLI run's, beside `launches_daemon` and `launches_grid`.

The last line is {"ok": true, "device": {...}}. Any failed check raises and
the script exits non-zero. Times come from CUDA events: `ms` around 20
calls from Python, and `graph_ms` around 20 replays of a CUDA graph of one
call, which leaves out the host's launch gaps (a port kernel that cannot be
captured fails the run; a cuDNN yardstick that cannot gets a null). TF32
is off and bf16 products accumulate in f32, as XLA's do. The
bounds use the H100 SXM data-sheet rates over the least work and bytes the
function needs on this run's inputs: 3.35 TB/s of HBM, 67 TFLOP/s f32
outside the tensor cores, and for the GRU's matrix products, which its
kernels run on the tensor cores at f32 accuracy as three TF32 products
each (3xTF32), 495 TFLOP/s of TF32, so 165 TFLOP/s of f32-accurate product;
the bf16 projections' products at 989 TFLOP/s of bf16.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

F32_PEAK = 67e12       # FLOP/s, f32 outside the tensor cores (H100 SXM)
BF16_PEAK = 989e12     # FLOP/s, bf16 on the tensor cores, dense (H100 SXM)
TF32_PEAK = 495e12     # FLOP/s, TF32 on the tensor cores, dense (H100 SXM)
HBM_RATE = 3.35e12     # bytes/s (H100 SXM)
# Limits on max |a - b|. The kernels sum in another order than the plain
# versions (cuBLAS on the card, the CPU's BLAS for the slice); every
# reading so far was at most 2.1e-7, so 1e-5 leaves a margin of about 50.
K1_TOL = 1e-5          # K1 kernel vs its plain version
K4_TOL = 1e-5          # K4 kernel vs its plain version
SLICE_TOL = 1e-5       # scores on the card vs scores on the CPU
LIBRARY_TOL = 1e-4     # cuDNN's GRU vs K1's plain version (read 6.6e-6); this
                       # only shows that the timed library call computes K1's
                       # function, it does not hold a kernel of the port
# The backward kernels against their plain versions. Gradients of inputs
# (dxi, dlatent) are held on max |a - b|; gradients of weights, which sum over
# every row and step (up to 48,640 terms at 8 days), on max |a - b| / max(1,
# max |b|).
K2_TOL = 1e-5
K5_TOL = 1e-5
# Card vs CPU, 8 deterministic training steps from the same weights: each
# step's loss (relative; read 2.8e-7, so the starting limit of 1e-4 is
# tightened to 1e-5), the first step's gradients (max |a - b| / max |b| per
# parameter; read 5.8e-6 at most, so the starting limit of 1e-4 is tightened
# to 5e-5) and every parameter after the 8th update (absolute; read
# 7.8e-6, Adam's step divides by sqrt(v) and so magnifies rounding in small
# gradients). A parameter whose first-step gradient on the CPU is at most
# ZERO_GRAD_ATOL everywhere is held apart: such a gradient is zero up to
# rounding (the portfolio bias: the softmax over stocks is invariant to a
# per-portfolio shift, |g| ~ 1e-9 against 1e-19 in f64), both devices feed
# Adam rounding noise, and Adam turns noise into steps of order lr. Its
# gradient on the card must be as small, and the parameter is held to the
# sum of the 8 steps' learning rates. The same holds, row by row, for the
# parameters of ZERO_GRAD_ROWS: the attention's key bias on a head whose
# valid scores are all positive (bk shifts each of them by bk . q / sqrt(H +
# 1e-6), the ReLU passes the shift and the softmax ignores it; |g| ~ 1e-10
# on the CPU, and its rounding noise differs between the folded scores of
# the kernels and the key rows of the plain version).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 5e-5
TRAIN_PARAM_ATOL = 1e-5
ZERO_GRAD_ATOL = 1e-6
ZERO_GRAD_ROWS = ("factor_predictor.key_bias",)    # (K, H): a row per head
# A bias's gradient is its layer's output gradient summed over the step's
# rows, and where those terms cancel the card and the CPU agree on the sum
# only as well as on the terms. The alpha head's mu bias, one number, sums
# 300 terms to 1/110 - 1/91,000 of their magnitudes on the 50 train days of
# the 80-day panel, so max |a - b| / max |b| read up to 1.3e-4 there while
# |a - b| stayed within 5e-8 of the terms' magnitudes on every day
# (scripts/torch_grad_conditioning.py, NVIDIA H100 80GB HBM3, 700.00 W).
# Where the CPU step records its terms, a bias entry is held to the larger
# of TRAIN_GRAD_RTOL x max |g| and SUM_RTOL x the sum of its terms'
# magnitudes: the first, unless the rows cancel the entry 50-fold or more.
SUM_RTOL = 1e-6
# A bfloat16 chunk, card against CPU: the per-day Spearman rank correlation
# of the scores (the serve gate of docs/precision.md). The two devices run
# the same bf16 rounding points but sum their products in other orders.
BF16_SPEARMAN = 0.99


def emit(obj) -> None:
    """One JSON line; keys starting with "_" go only to the --out file."""
    obj = {k: v for k, v in obj.items() if not str(k).startswith("_")}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(n_bytes: float, flops: float, tf32_flops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM's
    rate, the f32 operations over the f32 rate and the TF32 tensor-core
    operations over theirs."""
    t_bytes = n_bytes / HBM_RATE
    t_ops = max(flops / F32_PEAK, tf32_flops / TF32_PEAK)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gru_bound_ms(n_bytes: float, product_flops: float, elementwise_flops: float) -> tuple:
    """`bound_ms` of a GRU function: its matrix products at f32 accuracy on
    the tensor cores, three TF32 products each (3xTF32), as its kernels
    compute them; its elementwise steps at the f32 rate."""
    return bound_ms(n_bytes, elementwise_flops, 3.0 * product_flops)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
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


def graph_ms(torch, fn, reps: int = 20, library: bool = False):
    """CUDA-event time of one call of `fn` replayed from a CUDA graph: the
    card's time without the host's launch gaps, which `cuda_ms` includes
    when the host is slower than the card. A capture failure raises, but for
    a `library` yardstick, which gets (None, reason)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
    except RuntimeError as exc:
        if not library:
            raise
        torch.cuda.synchronize()
        return None, str(exc).splitlines()[0][:200]
    return cuda_ms(torch, graph.replay, reps=reps), None


def _timed(torch, fn, library: bool = False) -> dict:
    """Both clocks of one call: `ms` as called from Python (CUDA events
    around 20 calls) and `graph_ms` replayed from a CUDA graph."""
    ms = cuda_ms(torch, fn)
    g_ms, why = graph_ms(torch, fn, library=library)
    out = {"ms": ms, "graph_ms": g_ms}
    if why:
        out["graph_error"] = why
    return out


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    return {"phase": "device", "nvidia_smi": line,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> dict:
    from factorvae_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    return {"phase": "build", "seconds": seconds, "ptxas": ptxas}


def _gru_inputs(torch, g, n, t, h):
    xi = torch.randn(n, t, 3 * h, device="cuda", generator=g) * 0.5
    wh = (torch.rand(h, 3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
    bh = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
    return xi, wh, bh


def _cudnn_gru(torch, wh, bh):
    """cuDNN's GRU on K1's own inputs: an identity input weight makes its
    input projection return xi unchanged, so it computes K1's function, plus
    one (N*T, 3H) x (3H, 3H) product that its API cannot skip."""
    h = wh.shape[0]
    gru = torch.nn.GRU(3 * h, h, batch_first=True).cuda()
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * h, device="cuda"))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(wh.t())
        gru.bias_hh_l0.copy_(bh)
    return gru


def _k1_bound(n, t, h, residuals=False) -> tuple:
    """The least work of K1 at (N, T, H): the h . Wh products and ~10
    elementwise steps per (row, step, unit) against xi, the weights and h;
    the training variant also writes hseq and gseq."""
    product, elementwise = 2.0 * n * t * h * 3 * h, 10.0 * n * t * h
    n_bytes = 4.0 * (n * t * 3 * h + 3 * h * h + 3 * h + n * h)
    if residuals:
        n_bytes += 4.0 * n * t * 4 * h
    return product + elementwise, n_bytes, *gru_bound_ms(n_bytes, product, elementwise)


def _k1_timing(torch, args, label: str) -> dict:
    """K1 on xi (N, T, 3H), Wh, b: both variants' times beside the plain
    version's and cuDNN's nn.GRU forward (checked against the plain
    version), with the bounds."""
    from factorvae_tpu_torch.ops.kernels.gru import (
        gru_fwd,
        gru_fwd_plain,
        gru_fwd_residuals,
    )

    xi, wh, bh = args
    n, t, h = xi.shape[0], xi.shape[1], wh.shape[0]
    gru = _cudnn_gru(torch, wh, bh)
    with torch.no_grad():
        library_err = float((gru(xi)[1][0] - gru_fwd_plain(*args)).abs().max())
        library_ms = cuda_ms(torch, lambda: gru(xi))
    check(library_err <= LIBRARY_TOL, f"K1 {label}: cuDNN GRU differs by {library_err}")
    flops, n_bytes, b_ms, b_by = _k1_bound(n, t, h)
    r_flops, r_bytes, r_ms, r_by = _k1_bound(n, t, h, residuals=True)
    with torch.no_grad():
        library_graph_ms = graph_ms(torch, lambda: gru(xi), library=True)[0]
    out = {"shape": [n, t, h], **_timed(torch, lambda: gru_fwd(*args)),
           "plain_ms": cuda_ms(torch, lambda: gru_fwd_plain(*args)),
           "library_ms": library_ms, "library_graph_ms": library_graph_ms,
           "library_max_abs_err": library_err,
           "flops": flops, "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by,
           "residuals": {**_timed(torch, lambda: gru_fwd_residuals(*args)),
                         "plain_ms": cuda_ms(torch, lambda: gru_fwd_plain(
                             *args, keep_residuals=True)),
                         "bytes": r_bytes, "bound_ms": r_ms, "bound_by": r_by,
                         "residual_mb": 4.0 * n * t * 4 * h / 1e6}}
    out["library_ratio"] = out["ms"] / library_ms
    return out


def _k1_case(torch, args, what: str) -> dict:
    """K1's two variants on (xi, Wh, b) against the plain version: finite,
    bitwise on a repeat and across the variants, within K1_TOL."""
    from factorvae_tpu_torch.ops.kernels.gru import (
        gru_fwd,
        gru_fwd_plain,
        gru_fwd_residuals,
    )

    got, want = gru_fwd(*args), gru_fwd_plain(*args)
    again = gru_fwd(*args)
    res, res_want = gru_fwd_residuals(*args), gru_fwd_plain(*args, keep_residuals=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(torch.equal(got, again), f"{what}: a repeated call is not bitwise equal")
    check(torch.equal(got, res[0]),
          f"{what}: the residual variant's h differs from the serving variant's")
    err = float((got - want).abs().max())
    res_errs = {name: float((a - b).abs().max())
                for name, a, b in zip(("h", "hseq", "gseq"), res, res_want)}
    check(err <= K1_TOL and max(res_errs.values()) <= K1_TOL,
          f"{what}: max_abs_err {err}, residual variant {res_errs} > {K1_TOL}")
    xi, wh, _ = args
    return {"shape": [xi.shape[0], xi.shape[1], wh.shape[0]], "max_abs_err": err,
            "residual_errors": res_errs}


def phase_k1(torch, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = {"flagship": (32 * 304, 20, 64), "flagship_day": (304, 20, 64),
              "alpha360_k60_T60": (304, 60, 60), "ragged_h60": (1001, 20, 60),
              "odd_h37": (333, 7, 37)}
    cases, inputs = {}, {}
    for label, (n, t, h) in shapes.items():
        args = inputs[label] = _gru_inputs(torch, g, n, t, h)
        cases[label] = _k1_case(torch, args, f"K1 {label}")

    timing = {label: _k1_timing(torch, inputs[label], label)
              for label in ("flagship", "flagship_day", "alpha360_k60_T60")}
    serving, day = timing["flagship"], timing["flagship_day"]
    return {"phase": "K1", "cases": cases, "tolerance": K1_TOL,
            "max_abs_err": max(max(v["max_abs_err"], *v["residual_errors"].values())
                               for v in cases.values()),
            "bitwise_repeat": True,
            **{k: serving[k] for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                                       "library_graph_ms", "flops", "bytes", "bound_ms",
                                       "bound_by")},
            "residuals_row": {"max_abs_err": max(max(v["residual_errors"].values())
                                                 for v in cases.values()),
                              "tolerance": K1_TOL,
                              "ms": day["residuals"]["ms"],
                              "graph_ms": day["residuals"]["graph_ms"],
                              "plain_ms": day["residuals"]["plain_ms"],
                              "library_ms": day["library_ms"],
                              "library_graph_ms": day["library_graph_ms"],
                              "bound_ms": day["residuals"]["bound_ms"],
                              "bound_by": day["residuals"]["bound_by"]},
            "library": "torch.nn.GRU (cuDNN) over xi with an identity input "
                       "weight: K1's function plus a 3H x 3H input product",
            "timing": timing}


def _k4_inputs(torch, g, b, n, k, h, n_real):
    latent = torch.rand(b, n, h, device="cuda", generator=g) * 2 - 1
    mask = torch.zeros(b, n, dtype=torch.bool, device="cuda")
    mask[:, :n_real] = torch.rand(b, n_real, device="cuda", generator=g) > 0.05
    scale = 1.0 / h ** 0.5
    q = torch.randn(k, h, device="cuda", generator=g)
    wk = (torch.rand(k, h, h, device="cuda", generator=g) * 2 - 1) * scale
    bk = (torch.rand(k, h, device="cuda", generator=g) * 2 - 1) * scale
    wv = (torch.rand(k, h, h, device="cuda", generator=g) * 2 - 1) * scale
    bv = (torch.rand(k, h, device="cuda", generator=g) * 2 - 1) * scale
    return latent, mask, q, wk, bk, wv, bv


POISONED_K4 = (3, 5, 9)    # K4's serving batch: a NaN row (3), +inf (5), -inf (9)
POISONED_K5 = (2, 3, 6)    # K5's 8 days: a NaN row (2), +inf (3), -inf (6)


def _poison_inf(torch, latent, mask, q, wk, day_pos, day_neg, row) -> dict:
    """Make row `row` of day `day_pos` hold +inf, and of `day_neg` -inf, in
    one column each, and mark both rows valid. The columns are chosen so that
    the folded score s = L . u, u = Wk . q, is -inf on some head (u < 0 at
    the +inf column, u > 0 at the -inf one): a ReLU turns that into 0, so a
    kernel that folds the key product without an exact path would not guard
    the head. The score as written, (L . Wk) . q, sums infinities of both
    signs there and gives NaN: the head is guarded. Returns the columns and
    how many heads the folded form would miss."""
    u = torch.einsum("khj,kj->kh", wk, q)
    col_pos = int(u.min(dim=0).values.argmin())
    col_neg = int(u.max(dim=0).values.argmax())
    latent[day_pos, row, col_pos] = float("inf")
    latent[day_neg, row, col_neg] = float("-inf")
    mask[day_pos, row] = mask[day_neg, row] = True
    missed = {"+inf": int((u[:, col_pos] < 0).sum()), "-inf": int((u[:, col_neg] > 0).sum())}
    check(min(missed.values()) > 0, f"no head with a -inf folded score: {missed}")
    return {"columns": {"+inf": col_pos, "-inf": col_neg},
            "heads_a_bare_fold_misses": missed}


def _flagged(days) -> list:
    """The days whose flag a kernel's launch set: those that took the exact
    path."""
    return days.nonzero().flatten().tolist()


def _k4_checks(torch, g, h: int, what: str) -> dict:
    """K4 over a flagship 32-day chunk at hidden size h against its plain
    version: clean days (none may take the exact path), then an all-masked
    day, a NaN row and +inf / -inf rows, without and with a keep-mask (the
    guarded days zero, exactly they on the exact path)."""
    from factorvae_tpu_torch.ops.kernels import attention as attention_module
    from factorvae_tpu_torch.ops.kernels.attention import (
        attention_fwd,
        attention_fwd_plain,
    )

    b, n, k, n_real = 32, 304, 96, 300
    latent, mask, q, wk, bk, wv, bv = _k4_inputs(torch, g, b, n, k, h, n_real)
    weights = (q, wk, bk, wv, bv)
    group = attention_module._group(latent, k)

    # the serving inputs: padded rows and missing stocks only; no day takes
    # the exact path
    got = attention_fwd(latent, mask, *weights)
    err_serving = float((got - attention_fwd_plain(latent, mask, *weights)).abs().max())
    _, clean_days, _ = attention_module._fwd_launch(latent, mask, *weights, None, group,
                                                    exact=True)
    check(not _flagged(clean_days), f"{what}: a clean day took the exact path")

    # the guards: an all-masked day (7), a NaN latent row on day 3, and
    # +inf / -inf latent rows on days 5 / 9 placed where the folded score
    # L . (Wk q) is -inf on some head while the as-written score is NaN
    lat_g, mask_g = latent.clone(), mask.clone()
    mask_g[7] = False
    lat_g[3, 11] = float("nan")
    mask_g[3, 11] = True
    inf_heads = _poison_inf(torch, lat_g, mask_g, q, wk, 5, 9, 12)
    keep = (torch.rand(b, k, n, device="cuda", generator=g) > 0.1).float() / 0.9
    errs = {"serving": err_serving}
    exact = {}
    for label, kp in (("guards", None), ("guards_keep_mask", keep)):
        got_g = attention_fwd(lat_g, mask_g, *weights, keep=kp)
        want_g = attention_fwd_plain(lat_g, mask_g, *weights, keep=kp)
        _, days, _ = attention_module._fwd_launch(lat_g, mask_g, *weights, kp, group,
                                                  exact=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got_g).all()), f"{what} {label}: non-finite output")
        check(bool((got_g[7] == 0).all()), f"{what} {label}: all-masked day not zero")
        for day in POISONED_K4:
            check(bool((got_g[day] == 0).all()),
                  f"{what} {label}: poisoned day {day} not zeroed")
        check(bool((got_g[0] != 0).any()), f"{what} {label}: day 0 all zero")
        exact[label] = _flagged(days)
        check(exact[label] == list(POISONED_K4),
              f"{what} {label}: the exact path ran on days {exact[label]}, not "
              f"{POISONED_K4}")
        errs[label] = float((got_g - want_g).abs().max())
    check(max(errs.values()) <= K4_TOL, f"{what}: max_abs_err {errs} > {K4_TOL}")
    return {"errors": errs, "inf_rows": inf_heads,
            "exact_path_days": {"serving": _flagged(clean_days), **exact},
            "inputs": (latent, mask, weights), "group": group}


def phase_k4(torch, seed: int) -> dict:
    from factorvae_tpu_torch.ops.kernels import attention as attention_module
    from factorvae_tpu_torch.ops.kernels.attention import (
        attention_fwd,
        attention_fwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b, n, k, h, n_real = 32, 304, 96, 64, 300
    chunk = _k4_checks(torch, g, h, "K4")
    errs = chunk["errors"]
    latent, mask, weights = chunk["inputs"]
    group = chunk["group"]
    # other widths: csi800-k60 (N = 800, H = 60) and an H that is no
    # multiple of 4 (the kernel's zero-padded rows), with the keep-mask
    groups = {"serving": group}
    for label, shape in (("csi800_k60", (4, 800, 60, 60, 790)),
                         ("odd_h37", (3, 70, 6, 37, 66))):
        ob, on, ok_, oh, _ = shape
        other = _k4_inputs(torch, g, *shape)
        other[1][0] = False
        kp = (torch.rand(ob, ok_, on, device="cuda", generator=g) > 0.1).float() / 0.9
        errs[label] = max(
            float((attention_fwd(*other, keep=kp)
                   - attention_fwd_plain(*other, keep=kp)).abs().max()),
            float((attention_fwd(*other) - attention_fwd_plain(*other)).abs().max()))
        groups[label] = attention_module._group(other[0], ok_)
    err = max(errs.values())
    check(err <= K4_TOL, f"K4: max_abs_err {errs} > {K4_TOL}")

    serving = _k4_timing(torch, latent, mask, weights)
    # one flagship training day, the shape of 70 of the 73 launches of the
    # train and slice phases
    day = _k4_inputs(torch, g, 1, n, k, h, n_real)
    groups["flagship_day"] = attention_module._group(day[0], k)
    return {"phase": "K4", "shape": [b, n, k, h], "errors": errs,
            "max_abs_err": err, "tolerance": K4_TOL, "inf_rows": chunk["inf_rows"],
            "exact_path_days": chunk["exact_path_days"],
            "heads_per_cta": groups, **serving,
            "library": "none: no single PyTorch call computes this function",
            "flagship_day": {"shape": [1, n, k, h],
                             **_k4_timing(torch, day[0], day[1], day[2:])}}


def _k4_timing(torch, latent, mask, weights) -> dict:
    from factorvae_tpu_torch.ops.kernels.attention import (
        attention_fwd,
        attention_fwd_plain,
    )

    b, n, h = latent.shape
    k = weights[0].shape[0]
    kernel = _timed(torch, lambda: attention_fwd(latent, mask, *weights))
    plain_ms = cuda_ms(torch, lambda: attention_fwd_plain(latent, mask, *weights))
    # The least work of the function, counted over this run's valid rows
    # (masked rows need none). With u = Wk[k] . q[k] and c = bk[k] . q[k]
    # once per head (2H^2 + 2H), the score is L . u + c and the context
    # (a^T L) . Wv[k] + bv[k] sum(a): per valid row and head the score dot
    # (2H), the a^T L sum (2H) and six scalar steps (bias, scale, keep, ReLU,
    # exp, normalise); per (day, head) the (H,) . (H, H) product and the
    # bias term (2H^2 + 2H). No per-row H x H product is needed. Beside it:
    # what the kernel computes (its CTAs form u and c per (day, head), not
    # per head), and the earlier count, which held the value product per
    # valid row and head (2H^2 + H) as required.
    n_valid = int(mask.sum())
    per_row = 4.0 * h + 6.0
    per_day_head = 2.0 * h * h + 2.0 * h
    flops = k * n_valid * per_row + k * per_day_head + b * k * per_day_head
    flops_as_written = k * n_valid * per_row + 2 * b * k * per_day_head
    flops_with_value_product = (k * n_valid * (2.0 * h * h + 5.0 * h + 5.0)
                                + k * (2.0 * h * h + 2.0 * h))
    n_bytes = 4.0 * (b * n * h + k * (2 * h * h + 3 * h) + b * k * h) + b * n
    b_ms, b_by = bound_ms(n_bytes, flops)
    return {**kernel, "plain_ms": plain_ms, "library_ms": None,
            "valid_rows": n_valid, "flops": flops,
            "flops_as_written": flops_as_written,
            "flops_with_value_product": flops_with_value_product, "bytes": n_bytes,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_as_written": bound_ms(n_bytes, flops_as_written)[0],
            "bound_ms_with_value_product": bound_ms(n_bytes, flops_with_value_product)[0]}


def _stage_breakdown(torch, model, dataset, days) -> dict:
    """CUDA-event times of one 32-day chunk's stages."""
    from torch.nn.functional import leaky_relu

    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd

    day_idx = torch.as_tensor(days[:32], device="cuda")
    fe = model.feature_extractor
    slope = model.cfg.leaky_relu_slope
    with torch.inference_mode():
        x, _, mask = dataset.gather(day_idx)
        b, n = x.shape[:2]
        flat = x.reshape((b * n,) + tuple(x.shape[2:]))

        def projections():
            return fe.gru.input_proj(leaky_relu(fe.proj(fe.layer_norm(flat)), slope))

        xi = projections()
        latent = gru_fwd(xi, fe.gru.hidden_kernel, fe.gru.hidden_bias).reshape(b, n, -1)
        mu, sigma = model.factor_predictor.day_batched(latent, mask)
        stages = {
            "gather": lambda: dataset.gather(day_idx),
            "layernorm_proj_inputproj": projections,
            "gru_fwd (K1)": lambda: gru_fwd(xi, fe.gru.hidden_kernel, fe.gru.hidden_bias),
            "predictor (K4 + heads)": lambda: model.factor_predictor.day_batched(latent, mask),
            "decoder": lambda: model.factor_decoder(latent, mu, sigma, sample=False),
            "whole chunk": lambda: model.day_batched_prediction(x, mask, stochastic=False),
        }
        return {name: cuda_ms(torch, fn, reps=10, warmup=2) for name, fn in stages.items()}


def phase_slice(torch, seed: int, counters, idle) -> dict:
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon
    from factorvae_tpu_torch.serve.registry import ModelRegistry

    cfg = get_preset("flagship")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
    m = cfg.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    check(dataset.n_max == 304, f"n_max {dataset.n_max} != 304")
    model = load_model(cfg, device="cuda")
    registry = ModelRegistry(device="cuda")
    registry.admit(model, cfg, alias="flagship")
    daemon = ScoringDaemon(registry, dataset)
    dates = [str(d) for d in dataset.dates]
    day_req = {"id": 1, "model": "flagship", "day": dates[40], "top": 10}
    range_req = {"id": 2, "model": "flagship", "start": dates[19], "end": dates[52]}
    requests = [day_req, range_req, {"id": 3, "cmd": "ping"},
                {"id": 4, "cmd": "stats"}]

    daemon.handle_batch([day_req])     # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    for c in counters + idle:
        c.launches = 0
    t0 = time.perf_counter()
    responses = daemon.handle_batch(requests)
    tick_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters + idle}
    for c in counters:
        check(c.launches > 0, f"{c.__name__} was not launched on the main path")
    for c in idle:     # scoring keeps no residuals and runs no backward
        check(c.launches == 0, f"{c.__name__} was launched by a scoring tick")

    check(all(r["ok"] for r in responses), f"a request failed: {responses}")
    check(responses[0]["n"] == 10, "top-10 day request did not return 10 scores")
    ranged = responses[1]["results"]
    check(len(ranged) == 34, f"range returned {len(ranged)} days, not 34")
    got = np.asarray([r["scores"] for r in ranged], np.float32)       # (34, 300)
    check(got.shape == (34, 300) and bool(np.isfinite(got).all()),
          f"range scores shape {got.shape} or non-finite")

    # the same days on the CPU, where every kernel runs its plain version
    days = dataset.split_days(dates[19], dates[52])
    cpu_model = load_model(cfg, device="cpu")
    cpu_ds = PanelDataset(panel, seq_len=m.seq_len, device="cpu")
    want = predict_panel(cpu_model, cfg, cpu_ds, days, stochastic=False)[:, :300]
    err = float(np.abs(got - want).max())
    check(err <= SLICE_TOL, f"cuda vs cpu scores: max_abs_err {err} > {SLICE_TOL}")
    top = np.asarray(responses[0]["results"][0]["scores"])
    check(bool(np.all(np.diff(top) <= 0)), "top-10 scores not sorted")

    breakdown = _stage_breakdown(torch, model, dataset, days)
    return {"phase": "slice", "config": "flagship C158/T20/H64/K96/M128, f32",
            "panel": {"days": 80, "stocks": 300, "n_max": dataset.n_max},
            "launches": launches, "tick_ms": tick_ms,
            "latency_ms": {str(r["id"]): r.get("latency_ms") for r in responses},
            "cuda_vs_cpu_max_abs_err": err, "tolerance": SLICE_TOL,
            "score_range": [float(got.min()), float(got.max())],
            "chunk_stage_ms": breakdown}


def _grad_errors(got, want, names) -> dict:
    """max |a - b| for the first (an input's gradient), max |a - b| / max(1,
    max |b|) for the rest (weight gradients summed over rows)."""
    errs = {}
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        err = float((g - w).abs().max())
        errs[name] = err if i == 0 else err / max(1.0, float(w.abs().max()))
    return errs


def _gru_bwd_inputs(torch, g, n, t, h):
    xi = torch.randn(n, t, 3 * h, device="cuda", generator=g) * 0.5
    wh = (torch.rand(h, 3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
    bh = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
    dh = torch.randn(n, h, device="cuda", generator=g) * 0.1
    return xi, wh, bh, dh


def _k2_case(torch, args, what: str) -> dict:
    """K2 on (xi, Wh, b, dh) against its plain version: gru_bwd with its
    own residual forward and from given residuals (bitwise the same, and on
    a repeat), the dWh kernel alone on the plain walk's outputs (bitwise on
    a repeat); every gradient within K2_TOL. Returns the errors."""
    from factorvae_tpu_torch.ops.kernels.gru import (
        gru_bwd,
        gru_bwd_plain,
        gru_dwh,
        gru_dwh_plain,
        gru_fwd_residuals,
        gru_walk_plain,
    )

    names = ("dxi", "dWh", "db")
    xi, wh, bh, dh = args
    got, want = gru_bwd(*args), gru_bwd_plain(*args)
    again = gru_bwd(*args)
    # the training path: the walk from the residual variant's residuals
    _, hseq, gseq = gru_fwd_residuals(xi, wh, bh)
    from_res = gru_bwd(*args, residuals=(hseq, gseq))
    want_res = gru_bwd_plain(*args, residuals=(hseq, gseq))
    # the dWh kernel alone, on the plain walk's dxi and dg_n
    dxi_p, dgn_p = gru_walk_plain(xi, wh, hseq, gseq, dh)
    dw = gru_dwh(hseq, dxi_p, dgn_p)
    dw_again = gru_dwh(hseq, dxi_p, dgn_p)
    dw_want = gru_dwh_plain(hseq, dxi_p, dgn_p)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in got), f"{what}: non-finite")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: a repeated call is not bitwise equal")
    check(all(torch.equal(a, b) for a, b in zip(got, from_res)),
          f"{what}: the walk from given residuals differs from gru_bwd's own")
    check(all(torch.equal(a, b) for a, b in zip(dw, dw_again)),
          f"{what}: a repeated dWh call is not bitwise equal")
    errs = _grad_errors(got, want, names)
    errs.update({"residuals_" + k: v for k, v in
                 _grad_errors(from_res, want_res, names).items()})
    errs.update({"dwh_kernel_" + k: v for k, v in
                 _grad_errors((dxi_p,) + dw, (dxi_p,) + dw_want, names).items()
                 if k != "dxi"})
    check(max(errs.values()) <= K2_TOL, f"{what}: errors {errs} > {K2_TOL}")
    return errs


def phase_k2(torch, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    cases = {}
    for label, (n, t, h) in {"flagship_day": (304, 20, 64), "flagship_8_days": (2432, 20, 64),
                             "alpha360_k60_T60": (304, 60, 60),
                             "odd_h37": (333, 7, 37)}.items():
        errs = _k2_case(torch, _gru_bwd_inputs(torch, g, n, t, h), f"K2 {label}")
        cases[label] = {"shape": [n, t, h], "errors": errs}

    timing = {label: _k2_timing(torch, g, *shape)
              for label, shape in (("flagship_day", (304, 20, 64)),
                                   ("alpha360_k60_T60", (304, 60, 60)))}
    flagship = timing["flagship_day"]
    return {"phase": "K2", "cases": cases, "tolerance": K2_TOL,
            "max_abs_err": max(max(c["errors"].values()) for c in cases.values()),
            "bitwise_repeat": True,
            **{k: flagship[k] for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                                        "library_graph_ms", "flops", "bytes", "bound_ms",
                                        "bound_by")},
            "dwh_row": {"max_abs_err": max(v for c in cases.values()
                                           for k, v in c["errors"].items()
                                           if k.startswith("dwh_kernel_")),
                        "tolerance": K2_TOL,
                        **flagship["dwh"]},
            "library": "torch.nn.GRU (cuDNN) backward over xi with an identity input "
                       "weight, forward graph retained: K2's function plus the "
                       "gradient of a 3H x 3H input product",
            "timing": timing}


def _k2_timing(torch, g, n, t, h) -> dict:
    """At one (N, T, H): gru_bwd (its own residual forward, the walk, dWh),
    the plain version and cuDNN's GRU backward; the pair of the training
    path (residual forward + walk from its residuals) against cuDNN's
    forward + backward; the walk alone, at its launch rule's shape; the dWh
    kernel beside torch.matmul(hseq^T, dg); each with its bound."""
    from factorvae_tpu_torch.ops.kernels import gru as m
    from factorvae_tpu_torch.ops.kernels.gru import (
        gru_bwd,
        gru_bwd_plain,
        gru_dwh,
        gru_dwh_plain,
        gru_fwd_residuals,
        gru_walk_plain,
    )

    args = _gru_bwd_inputs(torch, g, n, t, h)
    xi, wh, bh, dh = args
    kernel = _timed(torch, lambda: gru_bwd(*args))
    plain_ms = cuda_ms(torch, lambda: gru_bwd_plain(*args))
    # cuDNN's GRU backward on K1's inputs (identity input weight, as in the
    # K1 phase), timed alone with the forward's graph retained. It also
    # computes the gradient of the identity input product.
    gru = _cudnn_gru(torch, wh, bh)
    xi_r = xi.clone().requires_grad_()
    out = gru(xi_r)[1][0]
    wrt = (xi_r, gru.weight_hh_l0, gru.bias_hh_l0)
    lib = torch.autograd.grad(out, wrt, dh, retain_graph=True)
    library_err = float((lib[0] - gru_bwd_plain(*args)[0]).abs().max())
    check(library_err <= LIBRARY_TOL, f"K2: cuDNN GRU backward differs by {library_err}")
    library = _timed(torch, lambda: torch.autograd.grad(out, wrt, dh, retain_graph=True),
                     library=True)
    # least work of the function with a recompute, as the standalone call
    # computes it (its own residual forward, then the walk): the recompute's
    # h . Wh, the walk's dg . Wh^T and h^T . dg (2*N*T*H*3H each) and ~30
    # elementwise steps per (row, step, unit)
    product, elementwise = 3 * 2.0 * n * t * h * 3 * h, 30.0 * n * t * h
    flops = product + elementwise
    n_bytes = 4.0 * (2 * n * t * 3 * h + n * h + 2 * (3 * h * h + 3 * h))
    b_ms, b_by = gru_bound_ms(n_bytes, product, elementwise)

    # the pair: what a training step runs, against cuDNN's forward+backward
    def pair():
        h_out, hseq, gseq = gru_fwd_residuals(xi, wh, bh)
        return h_out, gru_bwd(*args, residuals=(hseq, gseq))

    def library_pair():
        return torch.autograd.grad(gru(xi_r)[1][0], wrt, dh)

    # three H x 3H products per row and step and ~40 elementwise steps,
    # against xi read twice, dxi written, dh, the weights and the residuals
    # written once and read once
    pair_flops = product + 40.0 * n * t * h
    pair_bytes = n_bytes + 4.0 * (n * h + 2 * n * t * 4 * h)
    pair_b_ms, pair_b_by = gru_bound_ms(pair_bytes, product, 40.0 * n * t * h)

    # the walk alone, from the residuals: it reads xi, g, h_prev and dh and
    # Wh, writes dxi and dg_n, and runs T - 1 products dg . Wh^T
    _, hseq, gseq = gru_fwd_residuals(xi, wh, bh)
    shape = m._walk_shape(xi)
    walk_product = 2.0 * n * (t - 1) * h * 3 * h
    walk_bytes = 4.0 * (n * t * 11 * h + n * h + 3 * h * h)
    walk_b_ms, walk_b_by = gru_bound_ms(walk_bytes, walk_product, 30.0 * n * t * h)
    walk = {**_timed(torch, lambda: m._walk_launch(xi, wh, hseq, gseq, dh, shape)),
            "plain_ms": cuda_ms(torch, lambda: gru_walk_plain(xi, wh, hseq, gseq, dh)),
            "launch_shape": list(shape), "flops": walk_product + 30.0 * n * t * h,
            "bytes": walk_bytes, "bound_ms": walk_b_ms, "bound_by": walk_b_by}
    # the dWh kernel alone, on the residuals and a walk's outputs
    dxi, _, _ = gru_bwd(*args, residuals=(hseq, gseq))
    dgn = torch.randn(n, t, h, device="cuda", generator=g) * 0.1
    dg = torch.cat([dxi[..., :2 * h], dgn], dim=-1).reshape(-1, 3 * h)
    hflat = hseq.reshape(-1, h)
    dwh_flops = 2.0 * n * t * h * 3 * h + n * t * 3 * h
    dwh_bytes = 4.0 * (n * t * 4 * h + 3 * h * h + 3 * h)
    dwh_b_ms, dwh_b_by = gru_bound_ms(dwh_bytes, 2.0 * n * t * h * 3 * h, n * t * 3 * h)
    lib_pair = _timed(torch, library_pair, library=True)
    return {"shape": [n, t, h], **kernel, "plain_ms": plain_ms,
            "library_ms": library["ms"], "library_graph_ms": library["graph_ms"],
            "library_max_abs_err": library_err,
            "library_ratio": kernel["ms"] / library["ms"],
            "flops": flops, "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by,
            "pair": {**_timed(torch, pair),
                     "library_ms": lib_pair["ms"], "library_graph_ms": lib_pair["graph_ms"],
                     "library": "torch.nn.GRU (cuDNN) forward + backward, as above",
                     "flops": pair_flops, "bytes": pair_bytes, "bound_ms": pair_b_ms,
                     "bound_by": pair_b_by},
            "walk": walk,
            "dwh": {**_timed(torch, lambda: gru_dwh(hseq, dxi, dgn)),
                    "plain_ms": cuda_ms(torch, lambda: gru_dwh_plain(hseq, dxi, dgn)),
                    "library_ms": cuda_ms(torch, lambda: torch.matmul(hflat.T, dg)),
                    "library_graph_ms": graph_ms(torch, lambda: torch.matmul(hflat.T, dg),
                                                 library=True)[0],
                    "library": "torch.matmul(hseq^T, dg), TF32 off: dWh alone, without db",
                    "flops": dwh_flops, "bytes": dwh_bytes, "bound_ms": dwh_b_ms,
                    "bound_by": dwh_b_by}}


def _k5_case(torch, g, b, n, k, h, n_real, what: str) -> tuple:
    """K5 on `b` days of (n, k, h) with n_real rows against its plain
    version, without and with a keep-mask: finite, bitwise on a repeat,
    every gradient within K5_TOL; at b = 8 with an all-masked day (5) and
    NaN, +inf and -inf rows (POISONED_K5), which get no gradient and are
    exactly the days on the exact path. Returns (the case, its inputs)."""
    from factorvae_tpu_torch.ops.kernels import attention as attention_module
    from factorvae_tpu_torch.ops.kernels.attention import (
        attention_bwd,
        attention_bwd_plain,
    )

    names = ("dlatent", "dquery", "dWk", "dbk", "dWv", "dbv")
    latent, mask, *weights = _k4_inputs(torch, g, b, n, k, h, n_real)
    keep = (torch.rand(b, k, n, device="cuda", generator=g) > 0.1).float() / 0.9
    poisoned = ()
    if b == 8:     # an all-masked day (5); NaN, +inf, -inf rows (days 2, 3, 6)
        mask[5] = False
        latent[2, 7, 3] = float("nan")
        mask[2, 7] = True
        inf_rows = _poison_inf(torch, latent, mask, weights[0], weights[1], 3, 6, 9)
        poisoned = POISONED_K5
    dctx = torch.randn(b, k, h, device="cuda", generator=g) * 0.1
    group = attention_module._group(latent, k)
    errs, exact = {}, {}
    for kp_label, kp in (("", None), ("keep_", keep)):
        args = (latent, mask, *weights, dctx)
        got = attention_bwd(*args, keep=kp)
        want = attention_bwd_plain(*args, keep=kp)
        again = attention_bwd(*args, keep=kp)
        _, days, _ = attention_module._bwd_launch(*args, kp, group, exact=True)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in got), f"{what}: non-finite")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{what}: a repeated call is not bitwise equal")
        exact[kp_label + "days"] = _flagged(days)
        check(exact[kp_label + "days"] == list(poisoned),
              f"{what}: the exact path ran on days {exact[kp_label + 'days']}, "
              f"not {poisoned}")
        if b == 8:
            check(all(bool((got[0][d] == 0).all()) for d in POISONED_K5 + (5,)),
                  f"{what}: a guarded or the empty day got a gradient")
            check(bool((got[0][0] != 0).any()), f"{what}: day 0 got none")
        for name, err in _grad_errors(got, want, names).items():
            errs[kp_label + name] = err
    check(max(errs.values()) <= K5_TOL, f"{what}: errors {errs} > {K5_TOL}")
    case = {"shape": [b, n, k, h], "errors": errs, "heads_per_cta": group,
            "exact_path_days": exact}
    if b == 8:
        case["inf_rows"] = inf_rows
    return case, (latent, mask, *weights, dctx, keep)


def phase_k5(torch, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cases, timed = {}, {}
    for label, (b, n, k, h, n_real) in {"flagship_day": (1, 304, 96, 64, 300),
                                        "flagship_8_days": (8, 304, 96, 64, 300),
                                        "csi800_k60": (2, 800, 60, 60, 790),
                                        "odd_h37": (3, 70, 6, 37, 66)}.items():
        cases[label], inputs = _k5_case(torch, g, b, n, k, h, n_real, f"K5 {label}")
        if label in ("flagship_day", "flagship_8_days"):
            timed[label + ("_poisoned" if b == 8 else "")] = inputs
    # 8 clean days, the shape of a days_per_step = 8 training step; the
    # poisoned 8 days above show the cost of the exact path (3 of 8 days)
    clean = _k4_inputs(torch, g, 8, 304, 96, 64, 300)
    timed["flagship_8_days"] = (*clean, torch.randn(8, 96, 64, device="cuda", generator=g) * 0.1,
                                (torch.rand(8, 96, 304, device="cuda", generator=g) > 0.1).float()
                                / 0.9)

    timing = {label: _k5_timing(torch, *args) for label, args in timed.items()}
    day = timing["flagship_day"]
    return {"phase": "K5", "cases": cases, "tolerance": K5_TOL,
            "max_abs_err": max(max(c["errors"].values()) for c in cases.values()),
            "bitwise_repeat": True, "shape": day["shape"],
            **{key: day[key] for key in ("ms", "graph_ms", "plain_ms", "library_ms",
                                         "valid_rows", "flops", "flops_as_written",
                                         "flops_with_value_product", "bytes", "bound_ms",
                                         "bound_by", "bound_ms_as_written",
                                         "bound_ms_with_value_product")},
            "library": "none: no single PyTorch call computes this function",
            "timing": timing}


def _k5_timing(torch, latent, mask, q, wk, bk, wv, bv, dctx, keep) -> dict:
    from factorvae_tpu_torch.ops.kernels.attention import (
        attention_bwd,
        attention_bwd_plain,
    )

    args = (latent, mask, q, wk, bk, wv, bv, dctx)
    b, n, h = latent.shape
    k = q.shape[0]
    kernel = _timed(torch, lambda: attention_bwd(*args, keep=keep))
    plain_ms = cuda_ms(torch, lambda: attention_bwd_plain(*args, keep=keep))
    # The least work, over this run's valid rows (masked rows need none),
    # with the key and value products folded: per valid row and head the
    # score L . u (2H), da = L . w (2H), L^T dz and L^T a (4H), dL = dz u +
    # a w (4H) and ten scalar steps; per (day, head) w = Wv dctx, the dWv
    # outer product and the bias terms (4H^2 + 4H); per head u = Wk q, dq
    # and dWk (5H^2 + 5H). Beside it: what the kernels compute (kernel 1
    # also forms u and c per (day, head)), and the earlier count, which held
    # the value product per valid row and head (2H^2 + H) as required.
    n_valid = int(mask.sum())
    per_row = 12.0 * h + 10.0
    flops = k * n_valid * per_row + b * k * (4.0 * h * h + 4 * h) + k * (5.0 * h * h + 5 * h)
    flops_as_written = flops + b * k * (2.0 * h * h + 2 * h)
    flops_with_value_product = (k * n_valid * (2.0 * h * h + 13.0 * h + 10.0)
                                + b * k * (4.0 * h * h + 2 * h) + k * (5.0 * h * h + 5 * h))
    n_bytes = (4.0 * (2 * b * n * h + b * k * n + 2 * k * (2 * h * h + 3 * h) + b * k * h)
               + b * n)
    b_ms, b_by = bound_ms(n_bytes, flops)
    return {"shape": [b, n, k, h], **kernel, "plain_ms": plain_ms, "library_ms": None,
            "valid_rows": n_valid, "flops": flops, "flops_as_written": flops_as_written,
            "flops_with_value_product": flops_with_value_product,
            "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_as_written": bound_ms(n_bytes, flops_as_written)[0],
            "bound_ms_with_value_product": bound_ms(n_bytes, flops_with_value_product)[0]}


def _train_stage_breakdown(torch, trainer, state, steps: int = 12) -> dict:
    """CUDA-event times of one training step's stages, averaged over
    `steps` steps after one warm-up step."""
    from factorvae_tpu_torch.train.loop import batch_for

    order = trainer._order(trainer.train_days, True, 7)
    model, opt, ds = state.model, state.optimizer, trainer.ds
    names = ("gather", "forward (K1, K4, losses)", "backward (K2, K5)",
             "optimizer (Adam + schedule)")
    totals = dict.fromkeys(names, 0.0)
    for i in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        days = order[i % order.shape[0]]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        x, y, mask = batch_for(ds, days)
        ev[1].record()
        out = model.day_batched_forward(x, y, mask, train=True, generator=state.generator)
        loss = out.loss.sum()
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        state.scheduler.step()
        ev[4].record()
        ev[4].synchronize()
        if i:
            for j, name in enumerate(names):
                totals[name] += ev[j].elapsed_time(ev[j + 1]) / steps
    totals["whole step"] = sum(totals[nm] for nm in names)
    return totals


def _row_max(t):
    """max |t| over each slice along the first axis."""
    return t.abs().reshape(t.shape[0], -1).amax(dim=1)


def phase_train(torch, seed: int, counters) -> dict:
    import tempfile

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.state import learning_rate_at
    from factorvae_tpu_torch.train.trainer import Trainer

    base = get_preset("flagship")
    m = base.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    save_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                 val_start_time=dates[50], val_end_time=dates[69]),
        train=dataclasses.replace(base.train, seed=seed, num_epochs=1, days_per_step=1,
                                  checkpoint_every=0, save_dir=save_dir.name))
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    check(dataset.n_max == 304, f"n_max {dataset.n_max} != 304")
    trainer = Trainer(cfg, dataset, device="cuda")

    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state, summary = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the training path")
    # every training step's forward keeps the residuals its backward walks
    # from; validation (no_grad) runs the variant that keeps none
    steps = trainer.steps_per_epoch
    val_batches = -(-len(trainer.val_days) // trainer.batch_days)
    check(launches["gru_fwd_residuals"] == launches["gru_bwd"] == launches["gru_dwh"]
          == steps, f"train: {steps} steps but launches {launches}")
    check(launches["gru_fwd"] == val_batches,
          f"train: {val_batches} validation batches but launches {launches}")
    rec = summary["history"][0]
    for key in ("train_loss", "train_recon", "train_kl", "val_loss", "val_recon", "val_kl"):
        check(np.isfinite(rec[key]), f"train: {key} = {rec[key]} is not finite")
    check(rec["skipped_steps"] == 0, f"train: {rec['skipped_steps']} steps skipped")
    check(os.path.exists(os.path.join(save_dir.name, cfg.checkpoint_name(), "weights.pt")),
          "train: no best-validation weights written")
    # the same epoch again from a fresh state: the first one in a process
    # also pays one-time set-up (torch.optim imports torch._dynamo when the
    # first optimizer is built; first launches of each cuBLAS shape)
    t0 = time.perf_counter()
    _, warm = trainer.fit()
    torch.cuda.synchronize()
    warm_fit_s = time.perf_counter() - t0
    save_dir.cleanup()
    stages = _train_stage_breakdown(torch, trainer, state)

    # deterministic parity: the same run with dropout 0 and the NLL loss, 8
    # steps on the card and on the CPU from the same weights
    det = dataclasses.replace(cfg, model=dataclasses.replace(m, dropout_rate=0.0,
                                                             recon_loss="nll"))
    runs = {}
    for device in ("cuda", "cpu"):
        ds = dataset if device == "cuda" else PanelDataset(panel, seq_len=m.seq_len,
                                                           device="cpu")
        tr = Trainer(det, ds, device=device)
        st = tr.init_state()
        order = tr._order(tr.train_days, True, 0)
        losses, grads = [], None
        for i in range(8):
            aux = train_step(st, ds, order[i], guard=True)
            losses.append(aux["loss_sum"] / aux["days"])
            if i == 0:
                grads = {k: p.grad.detach().cpu() for k, p in st.model.named_parameters()}
        runs[device] = (torch.stack(losses).cpu().numpy(), grads,
                        {k: v.detach().cpu() for k, v in st.model.state_dict().items()},
                        st.scheduler.get_last_lr()[0])
    (loss_gpu, g_gpu, p_gpu, _), (loss_cpu, g_cpu, p_cpu, _) = runs["cuda"], runs["cpu"]
    loss_rel = float(np.max(np.abs(loss_gpu - loss_cpu) / np.abs(loss_cpu)))
    g_max = {k: float(g.abs().max()) for k, g in g_cpu.items()}
    zero_grad = sorted(k for k, m in g_max.items() if m <= ZERO_GRAD_ATOL)
    grad_errs = {k: float((g_gpu[k] - g_cpu[k]).abs().max()) / g_max[k]
                 for k in g_cpu if k not in zero_grad}
    param_errs = {k: float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu}
    lr_sum = sum(learning_rate_at(det.train, trainer.total_steps, i) for i in range(8))
    # rows of ZERO_GRAD_ROWS whose CPU gradient is zero up to rounding
    zero_rows = {k: _row_max(g_cpu[k]) <= ZERO_GRAD_ATOL for k in ZERO_GRAD_ROWS
                 if k not in zero_grad}
    zero_rows = {k: rows for k, rows in zero_rows.items() if bool(rows.any())}
    held = {k: v for k, v in param_errs.items() if k not in zero_grad}
    for k, rows in zero_rows.items():
        held[k] = float(_row_max(p_gpu[k] - p_cpu[k])[~rows].max())
    check(bool(np.isfinite(loss_gpu).all()), "train parity: non-finite loss on the card")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"train parity: losses differ by {loss_rel} (relative) > {TRAIN_LOSS_RTOL}")
    check(max(grad_errs.values()) <= TRAIN_GRAD_RTOL,
          f"train parity: first-step gradients differ: {grad_errs} > {TRAIN_GRAD_RTOL}")
    check(max(held.values()) <= TRAIN_PARAM_ATOL,
          f"train parity: parameters differ: {held} > {TRAIN_PARAM_ATOL}")
    zero_rows_report = {}
    for k in zero_grad + sorted(zero_rows):
        rows = zero_rows.get(k)
        g_card, err = g_gpu[k], p_gpu[k] - p_cpu[k]
        if rows is not None:
            g_card, err = _row_max(g_card)[rows], _row_max(err)[rows]
            zero_rows_report[k] = {"rows": int(rows.sum()), "of": int(rows.numel()),
                                   "card_grad_max": float(g_card.abs().max()),
                                   "param_err": float(err.abs().max())}
        card_g, moved = float(g_card.abs().max()), float(err.abs().max())
        check(card_g <= ZERO_GRAD_ATOL and moved <= lr_sum,
              f"train parity: {k} (zero gradient) has |g| {card_g} on the card and "
              f"moved by {moved} (lr sum {lr_sum})")

    epoch_s = warm["history"][0]["seconds"]
    windows = int(sum(dataset.valid[d].sum() for d in trainer.train_days))
    return {"phase": "train", "config": "flagship C158/T20/H64/K96/M128, f32, "
                                        "days_per_step=1, dropout 0.1, mse",
            "splits": {"train": [dates[0], dates[49]], "val": [dates[50], dates[69]],
                       "train_days": len(trainer.train_days),
                       "val_days": len(trainer.val_days)},
            "launches": launches, "epoch": rec, "fit_s": fit_s,
            "epoch_s_first": rec["seconds"], "warm_fit_s": warm_fit_s,
            # an epoch's wall, validation included, as the trainer's `seconds`
            "epoch_s": epoch_s, "train_windows": windows,
            "train_windows_per_s": windows / epoch_s,
            "step_stage_ms": stages,
            "parity": {"steps": 8, "config": "dropout_rate=0, recon_loss=nll",
                       "losses_cuda": loss_gpu.tolist(), "losses_cpu": loss_cpu.tolist(),
                       "loss_max_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
                       "grad_max_rel_err": max(grad_errs.values()),
                       "grad_rtol": TRAIN_GRAD_RTOL,
                       "grad_errors_top": dict(sorted(grad_errs.items(),
                                                      key=lambda kv: -kv[1])[:5]),
                       "param_max_abs_err": max(held.values()),
                       "param_atol": TRAIN_PARAM_ATOL,
                       "param_errors_top": dict(sorted(param_errs.items(),
                                                       key=lambda kv: -kv[1])[:5]),
                       "zero_grad_atol": ZERO_GRAD_ATOL,
                       "zero_grad_params": {k: {"cpu_grad_max": g_max[k],
                                                "card_grad_max": float(g_gpu[k].abs().max()),
                                                "param_err": param_errs[k]}
                                            for k in zero_grad},
                       "zero_grad_rows": zero_rows_report,
                       "zero_grad_bound": lr_sum}}


def _precision_stages(torch, model, dataset, days) -> dict:
    """CUDA-event times of one bfloat16 32-day chunk's stages, the upcast
    of xi to float32 for K1 as its own stage."""
    from torch.nn.functional import leaky_relu
    from torch.nn.functional import linear

    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd

    day_idx = torch.as_tensor(days[:32], device="cuda")
    fe = model.feature_extractor
    dtype = model.cfg.dtype
    w_in, b_in = fe.gru.input_proj.weight.to(dtype), fe.gru.input_proj.bias.float()
    with torch.inference_mode():
        x, _, mask = dataset.gather(day_idx)
        b, n = x.shape[:2]
        flat = x.reshape((b * n,) + tuple(x.shape[2:]))

        def front():
            z = fe.proj(fe.layer_norm(flat.to(dtype)))
            return leaky_relu(z, fe.slope)

        z = front()
        product = linear(z, w_in)
        xi = product + b_in
        latent = gru_fwd(xi, fe.gru.hidden_kernel, fe.gru.hidden_bias).to(dtype).float()
        latent = latent.reshape(b, n, -1)
        mu, sigma = model.factor_predictor.day_batched(latent, mask)
        stages = {
            "gather": lambda: dataset.gather(day_idx),
            "cast + layernorm + proj + leaky_relu (bf16)": front,
            "input_proj product (bf16 GEMM)": lambda: linear(z, w_in),
            "xi upcast + bias (bf16 -> f32)": lambda: product + b_in,
            "gru_fwd (K1)": lambda: gru_fwd(xi, fe.gru.hidden_kernel, fe.gru.hidden_bias),
            "predictor (K4 + heads)": lambda: model.factor_predictor.day_batched(latent, mask),
            "decoder": lambda: model.factor_decoder(latent, mu, sigma, sample=False),
            "whole chunk": lambda: model.day_batched_prediction(x, mask, stochastic=False),
        }
        out = {name: cuda_ms(torch, fn, reps=10, warmup=2) for name, fn in stages.items()}
        out["projections (bf16, as the model runs them)"] = cuda_ms(
            torch, lambda: fe.gru.input_proj(leaky_relu(fe.proj(fe.layer_norm(
                flat.to(dtype))), fe.slope), upcast=True), reps=10, warmup=2)
    m_rows, c, h3 = b * n * x.shape[2], x.shape[-1], xi.shape[-1]
    # the projections' least work: read the f32 windows once, write xi once
    # (f32, as K1 reads it); their products at the bf16 tensor-core rate
    n_bytes = 4.0 * m_rows * c + 4.0 * m_rows * h3
    flops = 2.0 * m_rows * c * (c + h3)
    t_bytes, t_ops = n_bytes / HBM_RATE, flops / BF16_PEAK
    upcast_bytes = 2.0 * m_rows * h3 + 4.0 * m_rows * h3
    return {"stage_ms": out,
            "projections_bound_ms": max(t_bytes, t_ops) * 1e3,
            "projections_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "projections_bytes": n_bytes, "projections_flops": flops,
            "xi_upcast_bytes": upcast_bytes,
            "xi_upcast_bound_ms": upcast_bytes / HBM_RATE * 1e3}


def phase_precision(torch, seed: int, counters) -> dict:
    """The precision ladder at flagship width: the kernels' hidden-size
    limit, a bfloat16 32-day chunk and int8 scores against the CPU, one
    mixed (bfloat16 over float32 masters) training epoch."""
    import tempfile

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model, with_compute_dtype
    from factorvae_tpu_torch.ops import kernels
    from factorvae_tpu_torch.ops.kernels import attention as attention_module
    from factorvae_tpu_torch.ops.kernels import gru as gru_module
    from factorvae_tpu_torch.ops.quant import quantize_params, tree_nbytes
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.registry import precision_config
    from factorvae_tpu_torch.train.trainer import Trainer

    # the kernels' one Python limit against the built libraries' kMaxH
    max_hidden = {name: getattr(mod._lib(name), f"{name}_max_hidden")()
                  for mod, name in ((gru_module, "gru_fwd"), (gru_module, "gru_bwd"),
                                    (attention_module, "attention_fwd"),
                                    (attention_module, "attention_bwd"))}
    check(all(v == kernels.MAX_HIDDEN for v in max_hidden.values()),
          f"precision: MAX_HIDDEN {kernels.MAX_HIDDEN} != the libraries' {max_hidden}")

    cfg = get_preset("flagship")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
    m = cfg.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    cpu_ds = PanelDataset(panel, seq_len=m.seq_len, device="cpu")
    model, cpu_model = load_model(cfg, device="cuda"), load_model(cfg, device="cpu")
    days = dataset.split_days(dates[19], dates[50])
    check(len(days) == 32, f"precision: {len(days)} days, not one 32-day chunk")

    # bf16 inputs reach the kernels upcast: bitwise the f32 call on them
    g = torch.Generator(device="cuda").manual_seed(seed)
    xi, wh, bh = _gru_inputs(torch, g, 304, 20, 64)
    xi16 = xi.to(torch.bfloat16)
    check(torch.equal(gru_module.gru_fwd(xi16, wh.to(torch.bfloat16), bh),
                      gru_module.gru_fwd(xi16.float(), wh.to(torch.bfloat16).float(), bh)),
          "precision: K1 on bf16 inputs differs from K1 on their f32 upcast")

    # a bfloat16 chunk, card against CPU, and against the f32 rung
    bf16 = precision_config(cfg, "bfloat16")
    model16 = with_compute_dtype(model, "bfloat16")       # shares the weights
    got = predict_panel(model16, bf16, dataset, days, stochastic=False)[:, :300]
    want = predict_panel(cpu_model, bf16, cpu_ds, days, stochastic=False)[:, :300]
    f32 = predict_panel(model, cfg, dataset, days, stochastic=False)[:, :300]
    check(bool(np.isfinite(got).all()), "precision: non-finite bf16 scores")
    rho = [_spearman(got[d], want[d]) for d in range(len(days))]
    rho_f32 = [_spearman(got[d], f32[d]) for d in range(len(days))]
    check(min(rho) >= BF16_SPEARMAN, f"precision: bf16 card vs CPU per-day Spearman "
                                     f"{min(rho)} < {BF16_SPEARMAN}")
    bf16_stages = _precision_stages(torch, model16, dataset, days)

    # int8 weight-only scores, card against CPU; the bytes of each rung
    q_card, q_cpu = quantize_params(model), quantize_params(cpu_model)
    got8 = predict_panel(model, cfg, dataset, days, stochastic=False, int8=True,
                         params=q_card)[:, :300]
    want8 = predict_panel(cpu_model, cfg, cpu_ds, days, stochastic=False, int8=True,
                          params=q_cpu)[:, :300]
    err8 = float(np.abs(got8 - want8).max())
    check(bool(np.isfinite(got8).all()) and err8 <= SLICE_TOL,
          f"precision: int8 card vs CPU scores differ by {err8} > {SLICE_TOL}")
    int8_ms = cuda_ms(torch, lambda: predict_panel(model, cfg, dataset, days, stochastic=False,
                                                   int8=True, params=q_card), reps=5)
    f32_ms = cuda_ms(torch, lambda: predict_panel(model, cfg, dataset, days,
                                                  stochastic=False), reps=5)
    bf16_ms = cuda_ms(torch, lambda: predict_panel(model16, bf16, dataset, days,
                                                   stochastic=False), reps=5)

    # one mixed epoch: bf16 compute over f32 masters, the dynamic loss scale
    save_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_mixed_")
    tcfg = dataclasses.replace(
        bf16,
        data=dataclasses.replace(cfg.data, start_time=dates[0], fit_end_time=dates[49],
                                 val_start_time=dates[50], val_end_time=dates[69]),
        train=dataclasses.replace(cfg.train, num_epochs=1, days_per_step=1,
                                  checkpoint_every=0, save_dir=save_dir.name))
    trainer = Trainer(tcfg, dataset, device="cuda")
    check(trainer.mixed, "precision: the bf16 trainer is not mixed")
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state, summary = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    steps = trainer.steps_per_epoch
    for name in ("gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_bwd"):
        check(launches[name] == steps, f"precision: {steps} mixed steps, launches {launches}")
    check(launches["attention_fwd"] > steps and launches["gru_fwd"] > 0,
          f"precision: launches {launches}")
    rec = summary["history"][0]
    for key in ("train_loss", "val_loss"):
        check(np.isfinite(rec[key]), f"precision: mixed {key} = {rec[key]}")
    check(all(p.dtype == torch.float32 for p in state.model.parameters()),
          "precision: the masters are not float32")
    check(all(v.dtype == torch.float32 for st in state.optimizer.state_dict()["state"].values()
              for k, v in st.items() if k != "step"), "precision: Adam's moments are not f32")
    budget = steps // tcfg.train.loss_scale_growth_interval + 1
    check(rec["skipped_steps"] <= budget,
          f"precision: {rec['skipped_steps']} skipped steps > budget {budget}")
    t0 = time.perf_counter()
    _, warm = trainer.fit()
    torch.cuda.synchronize()
    warm_fit_s = time.perf_counter() - t0
    save_dir.cleanup()
    windows = int(sum(dataset.valid[d].sum() for d in trainer.train_days))
    epoch_s = warm["history"][0]["seconds"]
    return {"phase": "precision", "config": "flagship C158/T20/H64/K96/M128",
            "max_hidden": {"python": kernels.MAX_HIDDEN, **max_hidden},
            "bf16_chunk": {"days": len(days), "card_vs_cpu_spearman_min": min(rho),
                           "spearman_limit": BF16_SPEARMAN,
                           "card_vs_cpu_max_abs_err": float(np.abs(got - want).max()),
                           "vs_f32_max_abs_err": float(np.abs(got - f32).max()),
                           "vs_f32_spearman_min": min(rho_f32),
                           "chunk_ms": {"float32": f32_ms, "bfloat16": bf16_ms,
                                        "int8": int8_ms},
                           **bf16_stages},
            "int8": {"card_vs_cpu_max_abs_err": err8, "tolerance": SLICE_TOL,
                     "vs_f32_max_abs_err": float(np.abs(got8 - f32).max()),
                     "param_bytes": {"float32": tree_nbytes(model),
                                     "int8": tree_nbytes(q_card)},
                     "quantized": sorted(k for k, v in q_card.items()
                                         if hasattr(v, "q"))},
            "mixed_epoch": {"launches": launches, "epoch": rec, "fit_s": fit_s,
                            "warm_fit_s": warm_fit_s, "epoch_s": epoch_s,
                            "epoch_s_first": rec["seconds"],
                            "loss_scale": rec["loss_scale"],
                            "skipped_steps": rec["skipped_steps"],
                            "skip_budget": budget, "train_windows": windows,
                            "train_windows_per_s": windows / epoch_s}}


def _spearman(a, b) -> float:
    ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
    return float(np.corrcoef(ra, rb)[0, 1])


CLI_DAYS = 120          # 50 train + 20 validation + 50 scored days
CLI_CPU_DAYS = 8        # the scored days held against the CPU


def _cli_drive(torch, cli, counters, argv, plan=None) -> dict:
    """cli.main(argv), under the chaos `plan` if one is given, with every
    launch counter set to 0 just before; its echo is kept, not printed (the
    result lines stay the script's own)."""
    import contextlib
    import io

    from factorvae_tpu_torch import chaos

    echo = io.StringIO()
    jsonl = argv[len(argv) - argv[::-1].index("--metrics_jsonl")]     # the last one counts
    offset = os.path.getsize(jsonl) if os.path.exists(jsonl) else 0   # the stream appends
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(echo), (
            chaos.active(plan) if plan is not None else contextlib.nullcontext()):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv[-4:])}: exit code {rc}")
    with open(jsonl) as fh:
        fh.seek(offset)
        events = [json.loads(line) for line in fh]
    return {"launches": {c.__name__: c.launches for c in counters}, "wall_s": wall,
            "events": events, "echo": echo.getvalue().splitlines()}


def _of(run, name) -> list:
    return [e for e in run["events"] if e["event"] == name]


def _csv_scores(path):
    import csv

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], np.array([float(r[2]) for r in rows[1:]], np.float32)


def _native_vs_numpy(pkl: str, pad_multiple: int) -> dict:
    """The pickle's panel build and the padded panel's fill maps with the
    native panel ops and with FACTORVAE_NATIVE=0: bitwise equal, each timed
    (host seconds)."""
    from factorvae_tpu_torch import native
    from factorvae_tpu_torch.data.panel import build_panel, load_frame
    from factorvae_tpu_torch.data.windows import compute_fill_maps

    df = load_frame(pkl)
    out, got = {}, {}
    for path in ("native", "numpy"):
        if path == "numpy":
            os.environ[native.ENV] = "0"
        try:
            native.reset_call_counts()
            t0 = time.perf_counter()
            panel = build_panel(df)
            t1 = time.perf_counter()
            n_max = -(-panel.num_instruments // pad_multiple) * pad_multiple
            valid = np.zeros((panel.num_days, n_max), bool)
            valid[:, :panel.num_instruments] = panel.valid
            t2 = time.perf_counter()
            maps = compute_fill_maps(valid)
            t3 = time.perf_counter()
        finally:
            os.environ.pop(native.ENV, None)
        counts = native.call_counts()
        check(all(counts[op][path] == 1 and sum(counts[op].values()) == 1
                  for op in native.OPS), f"cli: the {path} panel ops ran {counts}")
        got[path] = (panel.values, panel.valid, *maps)
        out[path] = {"build_panel_s": t1 - t0, "fill_maps_s": t3 - t2}
    same = [a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            for a, b in zip(got["native"], got["numpy"])]
    check(all(same), f"cli: native vs numpy panel ops not bitwise (values, valid, "
                     f"last_valid, next_valid): {same}")
    return {**out, "bitwise": True, "rows": int(got["native"][1].sum()),
            "dense_shape": list(got["native"][0].shape)}


def phase_cli(torch, seed: int, counters, card: str) -> dict:
    import tempfile

    from factorvae_tpu_torch import cli, native
    from factorvae_tpu_torch.chaos import ChaosPlan, Fault
    from factorvae_tpu_torch.data.panel import panel_to_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.presets import get_preset

    cfg = get_preset("flagship")
    panel = synthetic_panel_dense(CLI_DAYS, 300, cfg.model.num_features, seed=seed)
    d = [str(x) for x in panel.dates]
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    root = work.name
    pkl = os.path.join(root, "panel.pkl")
    t0 = time.perf_counter()
    panel_to_frame(panel).to_pickle(pkl)
    pickle_s = time.perf_counter() - t0
    base = ["--preset", "flagship", "--dataset", pkl, "--seed", str(seed),
            "--run_name", "smoke", "--start_time", d[0], "--fit_end_time", d[49],
            "--val_start_time", d[50], "--val_end_time", d[69], "--score_start", d[70],
            "--score_end", d[CLI_DAYS - 1], "--deterministic_scores"]

    def argv(out, *extra):
        return base + ["--save_dir", f"{root}/{out}/models",
                       "--score_dir", f"{root}/{out}/scores",
                       "--metrics_jsonl", f"{root}/{out}/run.jsonl", *extra]

    train_names = ("gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_bwd")
    # (a) three epochs, then score, export and backtest; the native panel
    # ops must serve its panel build and its fill maps
    native.reset_call_counts()
    a = _cli_drive(torch, cli, counters, argv("a", "--num_epochs", "3", "--backtest"))
    native_counts = native.call_counts()
    check(all(native_counts[op]["native"] > 0 and native_counts[op]["numpy"] == 0
              for op in native.OPS),
          f"cli (a): the native panel ops did not serve the run: {native_counts}")
    la = a["launches"]
    epochs = _of(a, "epoch")
    check([e["epoch"] for e in epochs] == [0, 1, 2], f"cli (a): epochs {epochs}")
    steps, val_batches, chunks = 50, 20, -(-(CLI_DAYS - 70) // 32)
    check(all(la[n] == 3 * steps for n in train_names),
          f"cli (a): {3 * steps} train steps but launches {la}")
    check(la["gru_fwd"] == 3 * val_batches + chunks,
          f"cli (a): {3 * val_batches} validation batches and {chunks} scoring chunks "
          f"but launches {la}")
    check(la["attention_fwd"] == la["gru_fwd"] + la["gru_fwd_residuals"],
          f"cli (a): one attention forward per model forward, launches {la}")
    for e in epochs:
        check(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"])
              and e["skipped_steps"] == 0, f"cli (a): epoch {e}")
    scores_a = _of(a, "scores")[0]
    check(np.isfinite(scores_a["rank_ic"]) and np.isfinite(scores_a["rank_ic_ir"]),
          f"cli (a): RankIC {scores_a}")
    csv_path = scores_a["path"]
    check(os.path.basename(csv_path) == "smoke_96_True_None_158_64.csv",
          f"cli (a): score CSV {csv_path}")
    head, csv_scores = _csv_scores(csv_path)
    valid_rows = int(panel.valid[70:CLI_DAYS].sum())
    check(head == ["datetime", "instrument", "score", "LABEL0"]
          and len(csv_scores) == valid_rows == scores_a["windows"]
          and bool(np.isfinite(csv_scores).all()),
          f"cli (a): CSV {head}, {len(csv_scores)} rows for {valid_rows} valid pairs")
    backtest = _of(a, "backtest") + _of(a, "backtest_account")
    check(len(backtest) == 2, "cli (a): no backtest events")

    # (b) resume to four epochs
    b = _cli_drive(torch, cli, counters, argv("a", "--num_epochs", "4", "--resume"))
    check([e["epoch"] for e in _of(b, "resume")] == [3]
          and [e["epoch"] for e in _of(b, "epoch")] == [3],
          f"cli (b): resume {_of(b, 'resume')}, epochs {_of(b, 'epoch')}")
    # (c) score only, from (b)'s best weights
    c = _cli_drive(torch, cli, counters, argv("a", "--num_epochs", "4", "--score_only"))
    lc = c["launches"]
    check(lc["gru_fwd"] == lc["attention_fwd"] == chunks
          and all(lc[n] == 0 for n in train_names + ("gru_fwd_residuals",)),
          f"cli (c): {chunks} scoring chunks but launches {lc}")
    rank_ic = (_of(b, "scores")[0]["rank_ic"], _of(c, "scores")[0]["rank_ic"])
    check(rank_ic[0] == rank_ic[1], f"cli (c): RankIC {rank_ic[1]} != (b)'s {rank_ic[0]}")
    # (d) the same weights on the CPU, first CLI_CPU_DAYS scored days
    cpu = _cli_drive(torch, cli, counters, argv(
        "a", "--num_epochs", "4", "--score_only", "--device", "cpu",
        "--score_end", d[70 + CLI_CPU_DAYS - 1], "--score_dir", f"{root}/cpu/scores",
        "--metrics_jsonl", f"{root}/cpu/run.jsonl"))
    _, card_scores = _csv_scores(_of(c, "scores")[0]["path"])
    _, cpu_scores = _csv_scores(_of(cpu, "scores")[0]["path"])
    n_cpu = int(panel.valid[70:70 + CLI_CPU_DAYS].sum())
    check(len(cpu_scores) == n_cpu, f"cli (d): {len(cpu_scores)} CPU rows, not {n_cpu}")
    cpu_err = float(np.max(np.abs(card_scores[:n_cpu] - cpu_scores)))
    check(cpu_err <= SLICE_TOL, f"cli (d): card vs CPU scores differ by {cpu_err}")
    # the same days through the score-file comparison, as the reference's
    # schema (datetime, instrument, score), the CPU's as the reference
    parity_csv = {}
    for who, run in (("cpu", cpu), ("card", c)):
        with open(_of(run, "scores")[0]["path"]) as fh:
            rows = [line.rstrip("\n").split(",")[:3] for line in fh][:1 + n_cpu]
        parity_csv[who] = os.path.join(root, f"{who}_days.csv")
        with open(parity_csv[who], "w") as fh:
            fh.writelines(",".join(r) + "\n" for r in rows)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "factorvae_tpu_torch.eval.compare",
                           parity_csv["cpu"], parity_csv["card"], "--labels", pkl],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    parity = json.loads(proc.stdout) if proc.returncode in (0, 1) else {}
    check(proc.returncode == 0 and parity.get("within_tolerance") is True
          and abs(parity["delta_rank_ic"]) <= 0.002 and parity["ours_days"] == CLI_CPU_DAYS,
          f"cli (d): eval.compare rc {proc.returncode} {proc.stdout[-400:]} {proc.stderr[-400:]}")
    parity["wall_s"] = time.perf_counter() - t0
    # (e) nan_grads at epochs 1 and 2 of 4, a fresh save_dir
    plan = ChaosPlan([Fault("nan_grads", epoch=1), Fault("nan_grads", epoch=2)])
    e = _cli_drive(torch, cli, counters, argv("e", "--num_epochs", "4"), plan=plan)
    trail = [r["epoch"] for r in _of(e, "epoch")]
    rec = _of(e, "recovery")
    check(trail == [0, 1, 2, 1, 2, 3], f"cli (e): epoch trail {trail}")
    check(len(rec) == 1 and rec[0]["kind"] == "rollback" and rec[0]["restored_step"] == 0
          and rec[0]["lr_scale"] == 0.5, f"cli (e): recovery {rec}")
    check([r["skipped_steps"] for r in _of(e, "epoch")] == [0, steps, steps, 0, 0, 0],
          f"cli (e): skipped steps {[r['skipped_steps'] for r in _of(e, 'epoch')]}")
    check(any(line.startswith("[recovery] kind=rollback") for line in e["echo"]),
          "cli (e): no [recovery] line")
    # (f) --bf16 --int8_scores: one mixed epoch, then int8 scores
    f = _cli_drive(torch, cli, counters, argv("f", "--num_epochs", "1", "--bf16",
                                             "--int8_scores"))
    lf = f["launches"]
    layout = _of(f, "execution_layout")[0]
    check(layout["compute_dtype"] == "bfloat16" and layout["mixed_precision"],
          f"cli (f): execution_layout {layout}")
    (ef,) = _of(f, "epoch")
    check(np.isfinite(ef["train_loss"]) and np.isfinite(ef["val_loss"])
          and ef["skipped_steps"] <= steps // 200 + 1 and ef["loss_scale"] > 0,
          f"cli (f): epoch {ef}")
    check(all(lf[n] == steps for n in train_names) and lf["gru_fwd"] == val_batches + chunks,
          f"cli (f): {steps} train steps, {val_batches} validation batches and {chunks} "
          f"scoring chunks but launches {lf}")
    scores_f = _of(f, "scores")[0]
    _, csv_f = _csv_scores(scores_f["path"])
    check(np.isfinite(scores_f["rank_ic"]) and len(csv_f) == valid_rows
          and bool(np.isfinite(csv_f).all()), f"cli (f): scores {scores_f}")
    panel_ops = _native_vs_numpy(pkl, cfg.data.pad_multiple)
    work.cleanup()

    windows = int(panel.valid[:50].sum())
    warm = epochs[-1]["seconds"]
    return {"phase": "cli", "entry": "main", "card": card,
            "config": "flagship C158/T20/H64/K96/M128, f32, days_per_step=1, "
                      "dropout 0.1, mse, --deterministic_scores",
            "splits": {"train": [d[0], d[49]], "val": [d[50], d[69]],
                       "score": [d[70], d[CLI_DAYS - 1]]},
            "pickle_s": pickle_s,
            "launches": {"a_train_score": la, "c_score_only": lc},
            "epoch_s_first": epochs[0]["seconds"], "epoch_s_warm": warm,
            "epoch_s": [r["seconds"] for r in epochs],
            "train_windows": windows, "train_windows_per_s": windows / warm,
            "score_s": scores_a["score_s"], "score_windows": scores_a["windows"],
            "score_windows_per_s": scores_a["windows"] / scores_a["score_s"],
            "csv_s": scores_a["export_s"], "rank_ic": scores_a["rank_ic"],
            "rank_ic_ir": scores_a["rank_ic_ir"],
            "backtest": {ev["event"]: {k: v for k, v in ev.items() if k not in ("ts", "event")}
                         for ev in backtest},
            "resume": {"epochs": [r["epoch"] for r in _of(b, "epoch")],
                       "rank_ic": rank_ic[0], "score_only_rank_ic": rank_ic[1]},
            "cpu_scores": {"days": CLI_CPU_DAYS, "rows": n_cpu, "max_abs_err": cpu_err,
                           "tolerance": SLICE_TOL},
            "compare": parity,
            "chaos": {"trail": trail, "recovery": {k: rec[0][k] for k in (
                "kind", "epoch", "restored_step", "lr_scale", "rollbacks")}},
            "bf16_int8": {"launches": lf, "epoch": {k: ef[k] for k in (
                "train_loss", "val_loss", "seconds", "skipped_steps", "loss_scale",
                "loss_scale_floor_steps")}, "rank_ic": scores_f["rank_ic"],
                "score_s": scores_f["score_s"], "windows": scores_f["windows"]},
            "walls_s": {"a": a["wall_s"], "b": b["wall_s"], "c": c["wall_s"],
                        "d_cpu": cpu["wall_s"], "e": e["wall_s"], "f": f["wall_s"]},
            "native_panel_ops": {"a_call_counts": native_counts, **panel_ops}}


# ---- fleets: the kernels' lane axis, FleetTrainer, the CLI's fleets ---------

FLEET_LANES = 4
# A lane of the fleet against the solo Trainer of its seed, one flagship
# epoch on the card: the fleet runs the model's products batched over lanes
# (vmap: cuBLAS's batched products, which sum in another order than the
# solo run's), then 50 Adam steps magnify that rounding in small gradients.
# A sound fleet reads about 2e-7 on an H100 (3e-7 on the CPU,
# tests/test_torch_fleet.py). A plumbing fault reads far more: the control
# below, a solo run whose lr is off by FLEET_FAULT_LR (relative), stands in
# for a lane whose lr, step count or bias correction is slightly wrong, and
# must read above the limit.
FLEET_LOSS_RTOL = 1e-5
FLEET_FAULT_LR = 1e-3


def _lanes_close(torch, got, want, what: str) -> float:
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"fleet {what}: non-finite output")
    return err


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _same_lanes(torch, a, b, lanes) -> bool:
    return all(bool(torch.equal(a[s], b[s])) for s in lanes)


def _fleet_gru(torch, g, n, t, h) -> dict:
    """K1 (both variants), the walk and dWh at S = FLEET_LANES lanes of four
    weight sets: against the lane-axis plain versions, each lane bitwise the
    one-lane launch of the same launch shape, a NaN in lane 2 leaving lanes
    0, 1 and 3 bitwise as they were; times at S lanes beside S one-lane
    launches; bounds S times the one-lane count (lanes share nothing)."""
    from factorvae_tpu_torch.ops.kernels import gru as m
    from factorvae_tpu_torch.ops.kernels import per_lane

    s_ = FLEET_LANES
    per = [_gru_bwd_inputs(torch, g, n, t, h) for _ in range(s_)]
    xi, wh, bh, dh = (torch.stack(parts) for parts in zip(*per))
    shape = m._shape(xi)
    others = [0, 1, 3]
    out = {"shape": [s_, n, t, h], "launch_shape": list(shape),
           "one_lane_launch_shape": list(m._shape(xi[0]))}
    # K1, serving and residual variants
    h_s = m.gru_fwd(xi, wh, bh)
    h_r, hseq, gseq = m.gru_fwd_residuals(xi, wh, bh)
    check(bool(torch.equal(h_s, h_r)), "fleet K1: residual h != serving h")
    plain = per_lane(m.gru_fwd_plain, xi, wh, bh)
    errs = {"K1": _lanes_close(torch, h_s, plain, "K1")}
    one = [m._fwd_launch("gru_fwd", xi[i], wh[i], bh[i], True, shape) for i in range(s_)]
    check(all(torch.equal(one[i][0], h_s[i]) and torch.equal(one[i][1], hseq[i])
              and torch.equal(one[i][2], gseq[i]) for i in range(s_)),
          "fleet K1: a lane differs from its one-lane launch")
    xi_p = xi.clone()
    xi_p[2, 5, 3, 7] = float("nan")
    h_p = m.gru_fwd(xi_p, wh, bh)
    check(_same_lanes(torch, h_p, h_s, others) and not bool(torch.isfinite(h_p[2]).all()),
          "fleet K1: a NaN in lane 2 reached another lane")
    # the walk and dWh from the residuals (a training step's backward)
    grads = m.gru_bwd(xi, wh, bh, dh, residuals=(hseq, gseq))
    want = per_lane(lambda *a: m.gru_bwd_plain(*a[:4], residuals=a[4:]),
                       xi, wh, bh, dh, hseq, gseq)
    errs["walk_dxi"] = _lanes_close(torch, grads[0], want[0], "walk")
    errs["dwh"] = max(_rel(grads[1][i], want[1][i]) for i in range(s_))
    errs["db"] = max(_rel(grads[2][i], want[2][i]) for i in range(s_))
    for i in range(s_):
        dxi_i, dgn_i = m._walk_launch(xi[i], wh[i], hseq[i], gseq[i], dh[i], shape)
        dwh_i, db_i = m.gru_dwh(hseq[i], dxi_i, dgn_i)
        check(bool(torch.equal(dxi_i, grads[0][i]) and torch.equal(dwh_i, grads[1][i])
                   and torch.equal(db_i, grads[2][i])),
              f"fleet walk/dWh: lane {i} differs from its one-lane launch")
    dh_p = dh.clone()
    dh_p[2, 0, 0] = float("nan")
    grads_p = m.gru_bwd(xi, wh, bh, dh_p, residuals=(hseq, gseq))
    check(all(_same_lanes(torch, a, b, others) for a, b in zip(grads_p, grads))
          and not bool(torch.isfinite(grads_p[1][2]).all()),
          "fleet walk/dWh: a NaN in lane 2 reached another lane")
    out["errors"] = errs
    check(errs["K1"] <= K1_TOL and errs["walk_dxi"] <= K2_TOL and errs["dwh"] <= K2_TOL
          and errs["db"] <= K2_TOL, f"fleet GRU: {errs} above {K1_TOL}")
    # times at S lanes and of one lane; bounds S times the one lane's
    _, _, b_ms, b_by = _k1_bound(n, t, h)
    _, _, r_ms, r_by = _k1_bound(n, t, h, residuals=True)
    product, elementwise = 2 * 2.0 * n * t * h * 3 * h, 30.0 * n * t * h
    walk_bytes = 4.0 * (n * t * 3 * h * 2 + n * t * 4 * h + n * h + 2 * (3 * h * h + 3 * h))
    w_ms, w_by = gru_bound_ms(walk_bytes, product, elementwise)
    dwh_ms, dwh_by = gru_bound_ms(4.0 * (n * t * 4 * h + 3 * h * h + 3 * h),
                                  2.0 * n * t * h * 3 * h, n * t * 3 * h)
    _, dgn = m._walk_launch(xi, wh, hseq, gseq, dh, shape)
    timing = {}
    for name, lanes_fn, one_fn, bound, by in (
            ("gru_fwd", lambda: m.gru_fwd(xi, wh, bh), lambda: m.gru_fwd(xi[0], wh[0], bh[0]),
             b_ms, b_by),
            ("gru_fwd_residuals", lambda: m.gru_fwd_residuals(xi, wh, bh),
             lambda: m.gru_fwd_residuals(xi[0], wh[0], bh[0]), r_ms, r_by),
            ("gru_bwd", lambda: m.gru_bwd(xi, wh, bh, dh, residuals=(hseq, gseq)),
             lambda: m.gru_bwd(xi[0], wh[0], bh[0], dh[0], residuals=(hseq[0], gseq[0])),
             w_ms, w_by),
            ("gru_dwh", lambda: m.gru_dwh(hseq, grads[0], dgn),
             lambda: m.gru_dwh(hseq[0], grads[0][0], dgn[0]), dwh_ms, dwh_by)):
        lanes_t, one_t = _timed(torch, lanes_fn), _timed(torch, one_fn)
        timing[name] = {"ms": lanes_t["ms"], "graph_ms": lanes_t["graph_ms"],
                        "one_lane_ms": one_t["ms"], "one_lane_graph_ms": one_t["graph_ms"],
                        "solo_x4_ms": s_ * one_t["ms"],
                        "solo_x4_graph_ms": s_ * one_t["graph_ms"],
                        "bound_ms": s_ * bound, "bound_by": by,
                        "one_lane_bound_ms": bound}
    out["timing"] = timing
    return out


def _fleet_attention(torch, g) -> dict:
    """K4 and K5 at S = FLEET_LANES lanes, one flagship training day each
    (B = 1, N = 304, K = 96, H = 64, with a keep-mask): against the lane-axis
    plain versions, each lane bitwise the one-lane launch of the same heads
    per CTA, a NaN latent row in lane 2 leaving lanes 0, 1 and 3 bitwise as
    they were and taking the exact path in lane 2's day alone; times and
    bounds as `_fleet_gru`."""
    from factorvae_tpu_torch.ops.kernels import attention as m
    from factorvae_tpu_torch.ops.kernels import per_lane

    s_, b, n, k, h, n_real = FLEET_LANES, 1, 304, 96, 64, 300
    per = [_k4_inputs(torch, g, b, n, k, h, n_real) for _ in range(s_)]
    lat, mask, q, wk, bk, wv, bv = (torch.stack(parts) for parts in zip(*per))
    weights = (q, wk, bk, wv, bv)
    keep = (torch.rand(s_, b, k, n, device="cuda", generator=g) > 0.1).float() / 0.9
    dctx = torch.randn(s_, b, k, h, device="cuda", generator=g)
    group = m._group(lat, k)
    others = [0, 1, 3]
    out = {"shape": [s_, b, n, k, h], "heads_per_cta": group,
           "one_lane_heads_per_cta": m._group(lat[0], k)}
    ctx = m.attention_fwd(lat, mask, *weights, keep=keep)
    errs = {"K4": _lanes_close(torch, ctx, per_lane(m.attention_fwd_plain, lat, mask,
                                                        *weights, keep), "K4")}
    grads = m.attention_bwd(lat, mask, *weights, dctx, keep=keep)
    want = per_lane(m.attention_bwd_plain, lat, mask, *weights, dctx, keep)
    errs["K5_dlatent"] = _lanes_close(torch, grads[0], want[0], "K5")
    errs["K5_weights"] = max(_rel(a[i], w[i]) for a, w in zip(grads[1:], want[1:])
                             for i in range(s_))
    for i in range(s_):
        lane = (lat[i], mask[i], *(w[i] for w in weights))
        one_ctx, _, _ = m._fwd_launch(*lane, keep[i], group)
        one_grads, _, _ = m._bwd_launch(*lane, dctx[i], keep[i], group)
        check(bool(torch.equal(one_ctx, ctx[i]))
              and all(torch.equal(a, w[i]) for a, w in zip(one_grads, grads)),
              f"fleet K4/K5: lane {i} differs from its one-lane launch")
    lat_p, mask_p = lat.clone(), mask.clone()
    lat_p[2, 0, 11] = float("nan")
    mask_p[2, 0, 11] = True
    ctx_p, days_f, _ = m._fwd_launch(lat_p, mask_p, *weights, keep, group, exact=True)
    grads_p, days_b, _ = m._bwd_launch(lat_p, mask_p, *weights, dctx, keep, group,
                                       exact=True)
    check(_same_lanes(torch, ctx_p, ctx, others)
          and all(_same_lanes(torch, a, w, others) for a, w in zip(grads_p, grads)),
          "fleet K4/K5: a NaN in lane 2 reached another lane")
    check(all(bool(torch.isfinite(a).all()) for a in (ctx_p, *grads_p)),
          "fleet K4/K5: the guarded lane's outputs are not finite")
    exact = {"K4": days_f.nonzero().tolist(), "K5": days_b.nonzero().tolist()}
    check(exact["K4"] == exact["K5"] == [[2, 0]],
          f"fleet K4/K5: the exact path ran on (lane, day) {exact}, not [[2, 0]]")
    out.update(errors=errs, exact_path_lane_days=exact)
    check(errs["K4"] <= K4_TOL and errs["K5_dlatent"] <= K5_TOL
          and errs["K5_weights"] <= K5_TOL, f"fleet K4/K5: {errs}")
    one4 = _k4_timing(torch, lat[0], mask[0], tuple(w[0] for w in weights))
    one5 = _k5_timing(torch, lat[0], mask[0], *(w[0] for w in weights), dctx[0], keep[0])
    timing = {}
    for name, fn, one in (
            ("attention_fwd", lambda: m.attention_fwd(lat, mask, *weights), one4),
            ("attention_bwd", lambda: m.attention_bwd(lat, mask, *weights, dctx, keep=keep),
             one5)):
        t = _timed(torch, fn)
        # lanes share nothing: S times the one-lane work (the lanes' valid
        # rows are within a few of each other; counted from lane 0's)
        b_ms, b_by = bound_ms(s_ * one["bytes"], s_ * one["flops"])
        timing[name] = {"ms": t["ms"], "graph_ms": t["graph_ms"],
                        "one_lane_ms": one["ms"], "one_lane_graph_ms": one["graph_ms"],
                        "solo_x4_ms": s_ * one["ms"], "solo_x4_graph_ms": s_ * one["graph_ms"],
                        "bound_ms": b_ms, "bound_by": b_by,
                        "one_lane_bound_ms": one["bound_ms"]}
    out["timing"] = timing
    return out


def _busy_share(torch, fn) -> dict:
    """Wall and device time of `fn` under torch.profiler: the kernels' and
    copies' summed durations over the host's wall (single stream). Null
    device time if the profiler shows none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            device_us += float(getattr(e, "self_device_time_total",
                                       getattr(e, "self_cuda_time_total", 0.0)))
    device_ms = device_us / 1e3 if device_us > 0 else None
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": None if device_ms is None else device_ms / wall_ms,
            "host_share": None if device_ms is None else 1.0 - device_ms / wall_ms}


def phase_fleet(torch, seed: int, counters, card: str) -> dict:
    import tempfile

    from factorvae_tpu_torch import cli
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import panel_to_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.train.fleet import FleetTrainer
    from factorvae_tpu_torch.train.loop import lane_train_step, train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    # (a) the kernels' lane axis; T = 60 / H = 60 is K3's case
    gru_day = _fleet_gru(torch, g, 304, 20, 64)
    gru_t60 = _fleet_gru(torch, g, 304, 60, 60)
    att = _fleet_attention(torch, g)

    # (b) a seed fleet of four, one flagship epoch, against solo runs
    base = get_preset("flagship")
    m = base.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                 val_start_time=dates[50], val_end_time=dates[69]),
        train=dataclasses.replace(base.train, seed=seed, num_epochs=1, days_per_step=1,
                                  checkpoint_every=0, save_dir=work.name))
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    seeds = [seed + i for i in range(FLEET_LANES)]
    fleet = FleetTrainer(cfg, dataset, seeds=seeds, device="cuda")
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state, out = fleet.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    steps = fleet.steps_per_epoch
    val_batches = -(-len(fleet.val_days) // fleet.batch_days)
    check(all(launches[n] == steps for n in ("gru_fwd_residuals", "gru_bwd", "gru_dwh",
                                              "attention_bwd"))
          and launches["gru_fwd"] == val_batches
          and launches["attention_fwd"] == steps + val_batches,
          f"fleet: {steps} steps and {val_batches} validation batches of {FLEET_LANES} "
          f"lanes, one launch each, but launches {launches}")
    rec = out["history"][0]
    check(all(np.isfinite(rec[k]).all() for k in ("train_loss", "val_loss"))
          and rec["skipped_steps"] == [0.0] * FLEET_LANES, f"fleet: epoch {rec}")
    _, warm = fleet.fit()
    torch.cuda.synchronize()
    solo, loss_rel = [], 0.0
    for i, s in enumerate(seeds):
        solo_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=s))
        tr = Trainer(solo_cfg, dataset, device="cuda")
        _, o = tr.fit()
        if i == 0:          # warm, as the fleet's second fit
            _, o = tr.fit()
        r = o["history"][0]
        solo.append(r)
        for key in ("train_loss", "val_loss"):
            loss_rel = max(loss_rel, abs(rec[key][i] - r[key]) / abs(r[key]))
    check(loss_rel <= FLEET_LOSS_RTOL,
          f"fleet: a lane's losses differ from its solo run by {loss_rel} (relative)")
    # the control: lane 0 against a solo run with its lr slightly off
    off_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=seeds[0], lr=cfg.train.lr * (1 + FLEET_FAULT_LR)))
    r = Trainer(off_cfg, dataset, device="cuda").fit()[1]["history"][0]
    fault_rel = max(abs(rec[k][0] - r[k]) / abs(r[k]) for k in ("train_loss", "val_loss"))
    check(fault_rel > FLEET_LOSS_RTOL,
          f"fleet: a solo run with its lr {FLEET_FAULT_LR} off reads {fault_rel}, "
          f"within the limit {FLEET_LOSS_RTOL}: the limit cannot tell it from a sound lane")
    # busy shares of 5 steps of the fleet and of one solo run
    order = torch.as_tensor(fleet._epoch_orders(0), device="cuda")
    peaks = [c.train.lr for c in fleet.lane_cfgs]
    fleet_busy = _busy_share(torch, lambda: [lane_train_step(
        fleet.model, state, dataset, order[:, i], peaks=peaks, train_cfg=cfg.train,
        total_steps=fleet.total_steps, guard=True) for i in range(5)])
    solo_tr = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=seeds[0])), dataset, device="cuda")
    solo_state = solo_tr.init_state()
    solo_busy = _busy_share(torch, lambda: [train_step(
        solo_state, dataset, order[0, i], guard=True) for i in range(5)])

    # (d) one lane equals the Trainer bitwise, on the card
    one_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=seeds[1], save_dir=os.path.join(work.name, "one")))
    st1, o1 = FleetTrainer(one_cfg, dataset, seeds=[seeds[1]], device="cuda").fit()
    stt, ot = Trainer(dataclasses.replace(one_cfg, train=dataclasses.replace(
        one_cfg.train, save_dir=os.path.join(work.name, "solo"))), dataset,
        device="cuda").fit()
    same = ([(r["train_loss"][0], r["val_loss"][0]) for r in o1["history"]]
            == [(r["train_loss"], r["val_loss"]) for r in ot["history"]]
            and all(torch.equal(st1.params[n][0], p) for n, p in stt.model.named_parameters()))
    check(same, "fleet: a one-lane fleet differs from Trainer.fit on the card")

    # (c) the CLI: --fleet_seeds 3 with --backtest, --score_only on the
    # winner, and a 2 x 2 lr:kl_weight --hyper_grid, one epoch each
    cli_panel = synthetic_panel_dense(CLI_DAYS, 300, m.num_features, seed=seed)
    d = [str(x) for x in cli_panel.dates]
    pkl = os.path.join(work.name, "panel.pkl")
    panel_to_frame(cli_panel).to_pickle(pkl)
    root = work.name

    def argv(out_dir, *extra):
        return ["--preset", "flagship", "--dataset", pkl, "--seed", str(seed),
                "--run_name", "fleet", "--start_time", d[0], "--fit_end_time", d[49],
                "--val_start_time", d[50], "--val_end_time", d[69], "--score_start", d[70],
                "--score_end", d[CLI_DAYS - 1], "--deterministic_scores", "--num_epochs", "1",
                "--save_dir", f"{root}/cli/models", "--score_dir", f"{root}/{out_dir}/scores",
                "--metrics_jsonl", f"{root}/{out_dir}/run.jsonl", *extra]

    chunks = -(-(CLI_DAYS - 70) // 32)
    train_names = ("gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_bwd")
    fs = _cli_drive(torch, cli, counters, argv("fs", "--fleet_seeds", "3", "--backtest"))
    lf = fs["launches"]
    (sweep_ev,) = _of(fs, "fleet_sweep")
    ics = {e["seed"]: e["rank_ic"] for e in _of(fs, "sweep_seed")}
    best = sweep_ev["best_seed"]
    scores_fs = _of(fs, "scores")[0]
    check(sorted(ics) == [seed, seed + 1, seed + 2] and best == max(ics, key=ics.get)
          and np.isfinite(scores_fs["rank_ic"]) and len(_of(fs, "backtest")) == 1,
          f"cli --fleet_seeds: sweep {ics}, winner {best}, scores {scores_fs}")
    # one launch per fleet step for the three lanes; validation batches; the
    # fleet's scoring pass and the winner's, a chunk each
    check(all(lf[n] == 50 for n in train_names) and lf["gru_fwd"] == 20 + 2 * chunks,
          f"cli --fleet_seeds: launches {lf}")
    so_argv = argv("so", "--score_only")
    so_argv[so_argv.index("--seed") + 1] = str(best)
    so = _cli_drive(torch, cli, counters, so_argv)
    rank_ic = (scores_fs["rank_ic"], _of(so, "scores")[0]["rank_ic"])
    check(rank_ic[0] == rank_ic[1],
          f"cli --score_only on seed {best}: RankIC {rank_ic[1]} != the fleet run's {rank_ic[0]}")
    hg = _cli_drive(torch, cli, counters, argv(
        "hg", "--hyper_grid", "1e-4:1,1e-4:0.5,3e-4:1,3e-4:0.5"))
    lh = hg["launches"]
    (hyper_ev,) = _of(hg, "hyper_grid")
    points = {e["label"]: e["rank_ic"] for e in _of(hg, "grid_point")}
    scores_hg = _of(hg, "scores")[0]
    check(len(points) == 4 and hyper_ev["best_label"] == max(points, key=points.get)
          and np.isfinite(scores_hg["rank_ic"]) and all(lh[n] == 50 for n in train_names),
          f"cli --hyper_grid: points {points}, {hyper_ev}, launches {lh}")
    work.cleanup()

    fleet_epoch, solo_epoch = warm["history"][0]["seconds"], solo[0]["seconds"]
    return {"phase": "fleet", "card": card, "lanes": FLEET_LANES,
            "config": "flagship C158/T20/H64/K96/M128, f32, days_per_step=1, "
                      "dropout 0.1, mse; 50 train and 20 validation days of 300 stocks",
            "kernels": {"gru_flagship_day": gru_day, "gru_alpha360_k60_T60": gru_t60,
                        "attention_flagship_day": att},
            "launches": launches,
            "seed_fleet": {"seeds": seeds, "fit_s_first": fit_s,
                           "epoch_s_first": rec["seconds"], "epoch_s_warm": fleet_epoch,
                           "solo_epoch_s": [r["seconds"] for r in solo],
                           "solo_epoch_s_warm": solo_epoch,
                           "fleet_over_solo_epoch": fleet_epoch / solo_epoch,
                           "fleet_over_4_solo_epochs": fleet_epoch / (FLEET_LANES * solo_epoch),
                           "train_loss": rec["train_loss"], "val_loss": rec["val_loss"],
                           "solo_train_loss": [r["train_loss"] for r in solo],
                           "loss_max_rel_err": loss_rel, "loss_rtol": FLEET_LOSS_RTOL,
                           "lr_off_loss_rel_err": fault_rel, "lr_off": FLEET_FAULT_LR,
                           "busy_5_steps": {"fleet": fleet_busy, "solo": solo_busy}},
            "one_lane_bitwise_trainer": same,
            "cli": {"fleet_seeds": {"rank_ic": ics, "best_seed": best,
                                    "score_rank_ic": rank_ic[0],
                                    "score_only_rank_ic": rank_ic[1], "launches": lf,
                                    "wall_s": fs["wall_s"]},
                    "hyper_grid": {"rank_ic": points, "best_label": hyper_ev["best_label"],
                                   "launches": lh, "wall_s": hg["wall_s"]}}}


# ---- stream residency: host-resident panels in double-buffered chunks ------

STREAM_CHUNK_DAYS = 16      # 50 train days -> chunks of 16, 16, 16 and a tail of 2
STREAM_LONG_DAYS = 3000     # the long history of the residency check (580 MB)
# Peak device memory of a stream scoring pass must not grow with the
# history: the 80-day and the 3,000-day panels' peaks within this many bytes.
STREAM_MEMORY_TOL = 16 * 2 ** 20
STREAM_BOUND_RUNS = 10      # (h): consumptions of an 8-chunk stream
STREAM_BOUND_FLOATS = 1 << 20
STREAM_SPIN_CYCLES = 200_000_000    # ~100 ms of device spin per chunk


def _same_bytes(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _history(out) -> list:
    """An epoch history without its wall-clock fields."""
    return [{k: v for k, v in r.items() if k not in ("seconds", "days_per_sec",
                                                     "seed_days_per_sec")}
            for r in out["history"]]


def _scoring_peak(torch, fn) -> tuple:
    """(peak device bytes above what was allocated before `fn`, fn's
    result, its wall in s)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before, out, time.perf_counter() - t0


def phase_stream(torch, seed: int, counters, card: str) -> dict:
    import tempfile

    from factorvae_tpu_torch import chaos, cli
    from factorvae_tpu_torch.chaos import ChaosPlan, Fault
    from factorvae_tpu_torch.data import PanelStore
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import Panel, panel_to_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel, predict_panel_fleet
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon
    from factorvae_tpu_torch.serve.registry import ModelRegistry
    from factorvae_tpu_torch.train.fleet import FleetTrainer
    from factorvae_tpu_torch.train.trainer import Trainer

    base = get_preset("flagship")
    m = base.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_stream_")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                 val_start_time=dates[50], val_end_time=dates[69],
                                 stream_chunk_days=STREAM_CHUNK_DAYS),
        train=dataclasses.replace(base.train, seed=seed, num_epochs=1, days_per_step=1,
                                  checkpoint_every=0, save_dir=work.name))
    residencies = ("hbm", "stream")
    ds = {r: PanelDataset(panel, seq_len=m.seq_len, device="cuda", residency=r)
          for r in residencies}
    check(not hasattr(ds["stream"], "values"), "stream: the dataset holds a device panel")

    # (a) Trainer.fit, one epoch from the same init, stream against hbm
    fits = {}
    for r in residencies:
        tr = Trainer(cfg, ds[r], device="cuda")
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        state, out = tr.fit()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        stats = ((tr.last_stream_stats.stats(), ds[r].last_stream.stats())
                 if r == "stream" else (None, None))
        _, warm = tr.fit()          # the same epoch again, warm
        torch.cuda.synchronize()
        fits[r] = {"trainer": tr, "state": state, "out": out, "launches": launches,
                   "stats": stats[0], "val_stats": stats[1], "warm": warm,
                   "warm_stats": (tr.last_stream_stats.stats() if r == "stream" else None)}
    tr_s, a_h, a_s = fits["stream"]["trainer"], fits["hbm"], fits["stream"]
    params_h = dict(a_h["state"].model.named_parameters())
    check(all(torch.equal(params_h[n], p) for n, p in a_s["state"].model.named_parameters()),
          "stream (a): parameters differ from the hbm run's")
    check(_history(a_h["out"]) == _history(a_s["out"]),
          f"stream (a): history {a_s['out']['history']} != {a_h['out']['history']}")
    check(_history(a_h["warm"]) == _history(a_s["warm"]), "stream (a): warm histories differ")
    steps = tr_s.steps_per_epoch
    val_batches = -(-len(tr_s.val_days) // tr_s.batch_days)
    ls = a_s["launches"]
    check(all(ls[n] == steps for n in ("gru_fwd_residuals", "gru_bwd", "gru_dwh",
                                        "attention_bwd"))
          and ls["gru_fwd"] == val_batches and ls["attention_fwd"] == steps + val_batches,
          f"stream (a): {steps} steps and {val_batches} validation batches but launches {ls}")
    train_stats = a_s["stats"]
    check(train_stats["chunks"] == -(-steps // tr_s.steps_per_chunk) >= 4
          and train_stats["retries"] == 0, f"stream (a): ledger {train_stats}")
    model = a_h["state"].model.eval()

    # (c) a seed fleet of four, one epoch, stream against hbm, per lane
    seeds = [seed + i for i in range(FLEET_LANES)]
    fleets = {}
    for r in residencies:
        fcfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=os.path.join(work.name, f"fleet_{r}")))
        ft = FleetTrainer(fcfg, ds[r], seeds=seeds, device="cuda")
        t0 = time.perf_counter()
        fstate, fout = ft.fit()
        torch.cuda.synchronize()
        fleets[r] = {"trainer": ft, "state": fstate, "out": fout,
                     "wall_s": time.perf_counter() - t0}
    f_h, f_s = fleets["hbm"], fleets["stream"]
    lanes_same = [all(torch.equal(f_h["state"].params[n][i], f_s["state"].params[n][i])
                      for n in f_h["state"].params) for i in range(FLEET_LANES)]
    check(all(lanes_same) and _history(f_h["out"]) == _history(f_s["out"]),
          f"stream (c): fleet lanes bitwise {lanes_same}")
    fleet_stats = f_s["trainer"].last_stream_stats.stats()

    # (b) scoring 50 days, stream against hbm: f32 (deterministic and
    # sampled), int8, and a fleet of four
    days = ds["hbm"].split_days(dates[30], dates[79])
    check(len(days) == 50, f"stream (b): {len(days)} scored days")
    scoring = {}
    for name, kw in (("f32", {}), ("f32_sampled", {"stochastic": True, "seed": seed}),
                     ("int8", {"int8": True})):
        kw = {"stochastic": False, **kw}
        got = {r: predict_panel(model, cfg, ds[r], days, **kw) for r in residencies}
        check(_same_bytes(got["hbm"], got["stream"]), f"stream (b): {name} scores differ")
        scoring[name] = ds["stream"].last_stream.stats()
    best = f_h["out"]["best_params"]
    got = {r: predict_panel_fleet(best, cfg, ds[r], days, stochastic=False)
           for r in residencies}
    check(got["hbm"].shape == (FLEET_LANES, 50, 304)
          and _same_bytes(got["hbm"], got["stream"]), "stream (b): fleet scores differ")
    want = got["stream"][0]

    # (d) chaos: a failed chunk retries once, a stalled one is waited for
    plan = ChaosPlan([Fault("stream_fail", chunk=1)])
    with chaos.active(plan):
        failed = predict_panel_fleet(best, cfg, ds["stream"], days, stochastic=False)[0]
    fail_stats = ds["stream"].last_stream.stats()
    check(fail_stats["retries"] == 1 and _same_bytes(failed, want),
          f"stream (d): stream_fail gave {fail_stats['retries']} retries")
    with chaos.active(ChaosPlan([Fault("stream_stall", chunk=0, delay_s=0.05)])):
        stalled = predict_panel_fleet(best, cfg, ds["stream"], days, stochastic=False)[0]
    stall_stats = ds["stream"].last_stream.stats()
    # the consumer waits for chunk 0's stall and then its produce
    stall_wait = stall_stats["chunk_wait_seconds"][0] - stall_stats["chunk_produce_seconds"][0]
    check(_same_bytes(stalled, want) and stall_wait >= 0.05,
          f"stream (d): a 50 ms stream_stall on chunk 0 added {stall_wait} s of wait")

    # (e) residency: the peak device memory of a 32-day-chunk stream scoring
    # pass over the whole 80-day and 3,000-day panels, and of the hbm dataset
    t0 = time.perf_counter()
    long_panel = synthetic_panel_dense(STREAM_LONG_DAYS, 300, m.num_features, seed=seed + 1)
    long_s = PanelDataset(long_panel, seq_len=m.seq_len, device="cuda", residency="stream")
    build_s = time.perf_counter() - t0
    all_80 = ds["stream"].split_days(None, None)
    all_long = long_s.split_days(None, None)
    peak_80, _, _ = _scoring_peak(torch, lambda: predict_panel(
        model, cfg, ds["stream"], all_80, stochastic=False))
    peak_long, long_scores, long_stream_s = _scoring_peak(torch, lambda: predict_panel(
        model, cfg, long_s, all_long, stochastic=False))
    long_stats = long_s.last_stream.stats()

    held = {}

    def hbm_pass():
        held["ds"] = PanelDataset(long_panel, seq_len=m.seq_len, device="cuda")
        return predict_panel(model, cfg, held["ds"], all_long, stochastic=False)

    peak_hbm, long_hbm_scores, _ = _scoring_peak(torch, hbm_pass)
    t0 = time.perf_counter()
    predict_panel(model, cfg, held.pop("ds"), all_long, stochastic=False)
    torch.cuda.synchronize()
    long_hbm_s = time.perf_counter() - t0
    check(_same_bytes(long_scores, long_hbm_scores), "stream (e): 3,000-day scores differ")
    check(abs(peak_long - peak_80) <= STREAM_MEMORY_TOL,
          f"stream (e): peak {peak_long} B at {STREAM_LONG_DAYS} days against {peak_80} B "
          f"at 80 days")
    check(max(peak_80, peak_long) < peak_hbm,
          f"stream (e): stream peaks {peak_80}, {peak_long} B not below hbm's {peak_hbm} B")
    n_long_chunks = -(-len(all_long) // 32)
    del long_panel, long_s

    # (f) a store append of 5 days, then extend_days and the daemon's pickup
    head = Panel(values=panel.values[:, :75], valid=panel.valid[:75],
                 dates=panel.dates[:75], instruments=panel.instruments)
    tail = Panel(values=panel.values[:, 75:], valid=panel.valid[75:],
                 dates=panel.dates[75:], instruments=panel.instruments)
    store = PanelStore.create(os.path.join(work.name, "store"), head)
    record = store.append_panel(tail)
    loaded = store.load_panel(verify=True)
    check(_same_bytes(loaded.values, panel.values) and _same_bytes(loaded.valid, panel.valid)
          and _same_bytes(loaded.dates, panel.dates), "stream (f): the store's round trip")
    piece = store.load_slab(record)
    new_days = np.arange(75, 80)
    extended = {}
    for r in residencies:
        grown = PanelDataset(head, seq_len=m.seq_len, device="cuda", residency=r)
        check(grown.extend_days(piece) and not grown.extend_days(piece),
              f"stream (f): extend_days under {r}")
        got = predict_panel(model, cfg, grown, new_days, stochastic=False)
        fresh = predict_panel(model, cfg, ds[r], new_days, stochastic=False)
        extended[r] = _same_bytes(got, fresh)
    check(all(extended.values()), f"stream (f): appended days' scores {extended}")
    registry = ModelRegistry(device="cuda")
    registry.admit(model, cfg, alias="flagship")
    daemon = ScoringDaemon(registry, PanelDataset(head, seq_len=m.seq_len, device="cuda",
                                                  residency="stream"))
    (before,) = daemon.handle_batch([{"id": 1, "model": "flagship", "day": dates[77]}])
    check(not before["ok"], "stream (f): the daemon scored a day it does not hold")
    check(daemon.extend_dataset(piece), "stream (f): extend_dataset added nothing")
    (resp,) = daemon.handle_batch([{"id": 2, "model": "flagship", "day": dates[77]}])
    fresh = predict_panel(model, cfg, ds["stream"], np.array([77]), stochastic=False)[0, :300]
    check(resp["ok"] and _same_bytes(np.asarray(resp["results"][0]["scores"], np.float32),
                                     fresh), "stream (f): the daemon's new day differs")

    # (g) the CLI, one epoch and 10 scored days: stream against hbm, the CSV
    pkl = os.path.join(work.name, "panel.pkl")
    panel_to_frame(panel).to_pickle(pkl)
    clis = {}
    for r in residencies:
        out = os.path.join(work.name, f"cli_{r}")
        clis[r] = _cli_drive(torch, cli, counters, [
            "--preset", "flagship", "--dataset", pkl, "--seed", str(seed),
            "--run_name", "smoke", "--start_time", dates[0], "--fit_end_time", dates[49],
            "--val_start_time", dates[50], "--val_end_time", dates[69],
            "--score_start", dates[70], "--score_end", dates[79], "--deterministic_scores",
            "--num_epochs", "1", "--panel_residency", r,
            "--stream_chunk_days", str(STREAM_CHUNK_DAYS),
            "--save_dir", f"{out}/models", "--score_dir", f"{out}/scores",
            "--metrics_jsonl", f"{out}/run.jsonl"])
    csv_bytes = {}
    for r in residencies:
        with open(_of(clis[r], "scores")[0]["path"], "rb") as fh:
            csv_bytes[r] = fh.read()
    check(csv_bytes["hbm"] == csv_bytes["stream"] and len(csv_bytes["hbm"]) > 0,
          "stream (g): the CLI's CSVs differ")
    work.cleanup()

    # (h) the two-chunk bound: an 8-chunk stream of 4 MB chunks whose
    # consumer's kernels lag ~100 ms behind its loop (a device spin), taken
    # STREAM_BOUND_RUNS times; the peak of device memory it adds stays below
    # three chunks every time
    from factorvae_tpu_torch.data.stream import ChunkStream

    def make_chunk(i, alloc):
        a = alloc("values", (STREAM_BOUND_FLOATS,), np.float32)
        a[...] = float(i)
        return (a,)

    chunk_bytes = 4 * STREAM_BOUND_FLOATS
    bound_peaks, bound_stats = [], None
    for _ in range(STREAM_BOUND_RUNS):
        firsts = []     # the last run's clones go before the baseline is read
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        bound = ChunkStream(make_chunk, 8, "cuda")
        for (t,) in bound:
            torch.cuda._sleep(STREAM_SPIN_CYCLES)
            firsts.append(t[:1].clone())
        del t
        torch.cuda.synchronize()
        bound_peaks.append(torch.cuda.max_memory_allocated() - before)
        check([float(f) for f in firsts] == [float(i) for i in range(8)],
              f"stream (h): chunks read {[float(f) for f in firsts]}")
        bound_stats = bound.stats()
    check(all(2 * chunk_bytes <= b < 3 * chunk_bytes for b in bound_peaks),
          f"stream (h): peaks {bound_peaks} B against chunks of {chunk_bytes} B")

    return {"phase": "stream", "card": card, "stream_chunk_days": STREAM_CHUNK_DAYS,
            "config": "flagship C158/T20/H64/K96/M128, f32, days_per_step=1",
            "train": {"launches": ls, "launches_hbm": a_h["launches"],
                      "steps": steps, "val_batches": val_batches,
                      "steps_per_chunk": tr_s.steps_per_chunk,
                      "epoch_s": {r: fits[r]["out"]["history"][0]["seconds"]
                                  for r in residencies},
                      "epoch_s_warm": {r: fits[r]["warm"]["history"][0]["seconds"]
                                       for r in residencies},
                      "ledger": train_stats, "ledger_warm": a_s["warm_stats"],
                      "val_ledger": a_s["val_stats"]},
            "fleet": {"lanes": FLEET_LANES, "ledger": fleet_stats,
                      "wall_s": {r: fleets[r]["wall_s"] for r in residencies}},
            "scoring": {"days": 50, "ledger": scoring},
            "chaos": {"stream_fail": fail_stats, "stream_stall": stall_stats,
                      "stall_wait_s": stall_wait},
            "residency": {"peak_bytes_80": peak_80, "peak_bytes_3000": peak_long,
                          "peak_bytes_hbm_3000": peak_hbm, "tolerance": STREAM_MEMORY_TOL,
                          "long_panel_nbytes": 304 * STREAM_LONG_DAYS * 159 * 4,
                          "long_build_s": build_s, "long_ledger": long_stats,
                          "chunks": n_long_chunks,
                          "chunk_ms": {"stream": long_stream_s * 1e3 / n_long_chunks,
                                       "hbm": long_hbm_s * 1e3 / n_long_chunks}},
            "append": {"slab": record, "extend_bitwise": extended},
            "bound": {"runs": STREAM_BOUND_RUNS, "chunks": 8, "chunk_bytes": chunk_bytes,
                      "peak_bytes": bound_peaks,
                      "peak_chunks": [b / chunk_bytes for b in bound_peaks],
                      "ledger": bound_stats},
            "cli": {"csv_bytes": len(csv_bytes["hbm"]),
                    "walls_s": {r: clis[r]["wall_s"] for r in residencies}}}


# ---------------------------------------------------------------------------
# 13. serve

SERVE_F32 = 8              # f32 flagship models of the fused bucket
SERVE_TOL = 1e-5           # fused lane vs its serial scores, max |a - b| / max(1, max |b|)
SERVE_DAYS = 32            # one scoring chunk
SERVE_SCALING_REPS = 15    # fused and serial ticks per S, medians kept
# the latency and load depths were halved (from 1,000 and 150 a client)
# to make room for the wide phase within the script's time
SERVE_LATENCY_N = 500      # requests per latency kind (p99 from 500)
SERVE_HTTP_PER_CLIENT = 75   # 8 HTTP clients: 600 requests


def _resp_scores(resp) -> np.ndarray:
    return np.concatenate([np.asarray(r["scores"], np.float32) for r in resp["results"]])


def _np_rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


def _pct(vals, q) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q)) if len(vals) else None


def _lat_stats(vals) -> dict:
    return {"p50_ms": _pct(vals, 50), "p99_ms": _pct(vals, 99),
            "max_ms": float(max(vals)) if len(vals) else None, "n": len(vals)}


def _device_split(torch, fn, reps: int = 3) -> dict:
    """Device time per call of `fn` by kind of kernel, and the top kernels,
    from torch.profiler's device events over `reps` calls after a profiled
    warm-up window (the first window pays the tracer's start); an error
    entry when the profiler sees no device time."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts):
            fn()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        parts = {"K1": 0.0, "K2/K3": 0.0, "K4": 0.0, "products": 0.0, "copies": 0.0,
                 "other": 0.0}
        top = []
        for ev in prof.key_averages():
            # kernels and copies only: an operator's row repeats its kernels' time
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if not us:
                continue
            ms = us / 1e3 / reps
            name = ev.key.lower()
            kind = ("K1" if re.search(r"gru_fwd(_wide)?_kernel", name)
                    else "K2/K3" if re.search(r"gru_(walk|dwh)(_wide|_reduce)?_kernel", name)
                    else "K4" if re.search(r"attention_fwd_(wide_|prep_|ctx_)?kernel", name)
                    else "products" if any(k in name for k in ("gemm", "cutlass", "xmma",
                                                                "sm90", "ampere"))
                    else "copies" if "memcpy" in name or "memset" in name else "other")
            parts[kind] += ms
            top.append((ms, ev.count // reps, ev.key[:80]))
        busy = sum(parts.values())
        if busy <= 0:
            return {"error": "the profiler recorded no device time", "wall_ms": wall}
        top.sort(reverse=True)
        return {"device_ms": parts, "busy_ms": busy, "wall_ms": wall,
                "idle_share": max(0.0, 1.0 - busy / wall),
                "top_kernels": [{"ms": ms, "per_call": n, "name": k} for ms, n, k in top[:10]]}
    except Exception as exc:        # noqa: BLE001 - a yardstick, not a check
        return {"error": str(exc).splitlines()[0][:200]}


class _Records:
    """A MetricsLogger stand-in that keeps the timeline's records in memory."""

    def __init__(self):
        self.records = []

    def log(self, event, _echo=False, **fields):
        self.records.append({"event": event, **fields})


def _start_front(serve_http, daemon, scheduler) -> tuple:
    """serve_http(daemon, scheduler=...) on 127.0.0.1, any free port, in a
    thread: (port, thread)."""
    import threading

    bound, port = threading.Event(), {}

    def ready(server):
        port["n"] = server.server_address[1]
        bound.set()

    thread = threading.Thread(target=serve_http, args=(daemon, 0),
                              kwargs=dict(scheduler=scheduler, ready=ready))
    thread.start()
    check(bound.wait(30), "serve: the HTTP front did not bind")
    return port["n"], thread


def _http(conn, method, path, body=None) -> tuple:
    conn.request(method, path, body=None if body is None else json.dumps(body))
    r = conn.getresponse()
    return r.status, r.read().decode()


def _serve_timeline(fn):
    """Run `fn` with a timeline installed; its result, and its marks and spans."""
    from factorvae_tpu_torch.utils.logging import Timeline, install_timeline

    sink = _Records()
    prev = install_timeline(Timeline(sink))
    try:
        out = fn()
    finally:
        install_timeline(prev)
    return out, sink.records


def _span_ms(recs, name) -> float:
    return 1e3 * sum(r["dur"] for r in recs if r.get("event") == "span" and r["name"] == name)


def _recording(seen: list, tag: dict) -> dict:
    """Wrap K1's and K4's launch helpers (`_fwd_launch` of the gru and the
    attention kernel modules) so that every launch keeps its inputs (as the
    kernel gets them: upcast and checked) and its output in `seen`, under
    the current `tag["rung"]` (none while it is None). The launch itself is unchanged, and so are
    the wrappers' launch counters. Returns the originals, for `_restore`."""
    from factorvae_tpu_torch.ops.kernels import attention as attention_module
    from factorvae_tpu_torch.ops.kernels import gru as gru_module

    real = {gru_module: gru_module._fwd_launch, attention_module: attention_module._fwd_launch}

    def gru_launch(name, xi, w_h, b_h, residuals, shape):
        res = real[gru_module](name, xi, w_h, b_h, residuals, shape)
        if tag["rung"] is not None:
            seen.append((tag["rung"], name, (xi, w_h, b_h), res[0]))
        return res

    def attention_launch(*args):
        res = real[attention_module](*args)
        if tag["rung"] is not None:
            seen.append((tag["rung"], "attention_fwd", args[:8], res[0]))
        return res

    gru_module._fwd_launch = gru_launch
    attention_module._fwd_launch = attention_launch
    return real


def _restore(real: dict) -> None:
    for module, launch in real.items():
        module._fwd_launch = launch


def phase_serve(torch, seed: int, counters, card: str) -> dict:
    import http.client
    import tempfile
    import threading

    from factorvae_tpu_torch import chaos
    from factorvae_tpu_torch.chaos import ChaosPlan, Fault
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.ops.kernels import plain
    from factorvae_tpu_torch.ops.kernels.attention import attention_fwd_plain
    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd_plain
    from factorvae_tpu_torch.params import save_weights
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import (
        ScoringDaemon,
        TickScheduler,
        serve_batch_file,
        serve_http,
    )
    from factorvae_tpu_torch.serve.registry import ModelRegistry

    base = get_preset("flagship")
    m = base.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    dates = [str(d) for d in dataset.dates]
    days32 = dataset.split_days(dates[40], dates[71])
    check(len(days32) == SERVE_DAYS, f"serve: {len(days32)} days, not {SERVE_DAYS}")
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")

    def cfg_of(s):
        return dataclasses.replace(base, train=dataclasses.replace(base.train, seed=s))

    # (a) eight f32 flagship models, two bf16 and two int8, all warmed; the
    # same models on the CPU, where every kernel runs its plain version
    def models_on(device):
        reg = ModelRegistry(device=device)
        for i in range(SERVE_F32):
            c = cfg_of(seed + i)
            model = load_model(c, device=device)
            reg.register_params(model, c, alias=f"f{i}")
            if i < 2:
                reg.register_params(model, c, precision="bfloat16", alias=f"b{i}")
                reg.register_params(model, c, precision="int8", alias=f"q{i}")
        return reg

    t0 = time.perf_counter()
    registry = models_on("cuda")
    admit_s = time.perf_counter() - t0
    cpu_daemon = ScoringDaemon(models_on("cpu"),
                               PanelDataset(panel, seq_len=m.seq_len, device="cpu"))
    warm = registry.warmup(dataset)
    check(len(warm) == SERVE_F32 + 4 and all(e["compiled"] for e in registry.stats()["entries"]),
          f"serve (a): warmed {len(warm)} of {SERVE_F32 + 4}")
    daemon = ScoringDaemon(registry, dataset)
    one_day = {"start": dates[40], "end": dates[71]}

    def tick(aliases):
        return daemon.handle_batch([{"id": a, "model": a, **one_day} for a in aliases])

    def serial(aliases):
        return {a: registry.score(a, dataset, days32) for a in aliases}

    # (b) one tick of 8 requests for the same 32 days: one fused dispatch,
    # K1's serving variant and K4 once for the whole bucket; then the bf16
    # and the int8 pairs. Each launch's inputs and output are kept, to be
    # held against the kernel's plain version after the run.
    buckets = {"float32": [f"f{i}" for i in range(SERVE_F32)],
               "bfloat16": ["b0", "b1"], "int8": ["q0", "q1"]}
    want = {rung: serial(al) for rung, al in buckets.items()}
    for al in buckets.values():
        tick(al)                     # the stacks' first build, the fused path warm
    torch.cuda.synchronize()
    seen, tag = [], {"rung": None}
    real = _recording(seen, tag)
    for c in counters:
        c.launches = 0
    fused, per_bucket, errs = {}, {}, {}
    before = dict(fused_requests=daemon.fused_requests, dispatches=daemon.dispatches)
    counters_by_name = {c.__name__: c for c in counters}

    def main_path():
        for rung, al in buckets.items():
            tag["rung"] = rung
            k1 = counters_by_name["gru_fwd"].launches
            k4 = counters_by_name["attention_fwd"].launches
            fr = daemon.fused_requests
            t1 = time.perf_counter()
            fused[rung] = tick(al)
            wall = (time.perf_counter() - t1) * 1e3
            per_bucket[rung] = {"lanes": len(al), "tick_ms": wall,
                                "fused_requests": daemon.fused_requests - fr,
                                "gru_fwd": counters_by_name["gru_fwd"].launches - k1,
                                "attention_fwd": counters_by_name["attention_fwd"].launches - k4}

    try:
        _, recs = _serve_timeline(main_path)
        torch.cuda.synchronize()
    finally:
        _restore(real)
    launches = {c.__name__: c.launches for c in counters}
    # each launch against its plain version on the inputs it got, on the card
    plain_fn = {"gru_fwd": gru_fwd_plain, "attention_fwd": attention_fwd_plain}
    kernel_errs: dict = {}
    with torch.inference_mode():
        for rung, name, args, out in seen:
            check(name in plain_fn, f"serve (b): {name} launched on the main path")
            ref = plain(plain_fn[name], args[0].ndim == 4, *args)
            err = float((out - ref).abs().max())
            key = f"{rung}/{name}"
            kernel_errs[key] = {"max_abs_err": max(err, kernel_errs.get(key, {}).get(
                "max_abs_err", 0.0)), "shape": list(args[0].shape)}
    del seen
    check(sorted(kernel_errs) == sorted(f"{r}/{n}" for r in buckets for n in plain_fn),
          f"serve (b): the kernels launched on the main path {sorted(kernel_errs)}")
    for key, e in kernel_errs.items():
        tol = K1_TOL if key.endswith("gru_fwd") else K4_TOL
        check(e["max_abs_err"] <= tol, f"serve (b): {key} vs its plain version {e} > {tol}")
    # the same ticks on the CPU
    cpu_out = {rung: cpu_daemon.handle_batch([{"id": a, "model": a, **one_day} for a in al])
               for rung, al in buckets.items()}
    fallbacks = [r for r in recs if r.get("name") == "fused_fallback"]
    check(not fallbacks, f"serve (b): fused_fallback on healthy traffic: {fallbacks}")
    check(daemon.fused_requests - before["fused_requests"] == SERVE_F32 + 4
          and daemon.dispatches - before["dispatches"] == 3,
          f"serve (b): fused_requests +{daemon.fused_requests - before['fused_requests']}, "
          f"dispatches +{daemon.dispatches - before['dispatches']}")
    cpu_errs = {}
    for rung, al in buckets.items():
        pb = per_bucket[rung]
        check(pb["fused_requests"] == len(al) and pb["gru_fwd"] == 1 and pb["attention_fwd"] == 1,
              f"serve (b): the {rung} bucket of {len(al)}: {pb}")
        worst, worst_cpu, rho = 0.0, 0.0, 1.0
        for resp, on_cpu in zip(fused[rung], cpu_out[rung]):
            check(resp["ok"] and resp["batched_with"] == len(al)
                  and on_cpu["ok"] and on_cpu["batched_with"] == len(al),
                  f"serve (b): {resp.get('error')} {on_cpu.get('error')}")
            ref = want[rung][resp["alias"]][:, :300].reshape(-1)
            got = _resp_scores(resp)
            check(got.shape == ref.shape and bool(np.isfinite(got).all()),
                  f"serve (b): {resp['alias']} scores {got.shape}")
            worst = max(worst, _np_rel(got, ref))
            cpu = _resp_scores(on_cpu)
            check(cpu.shape == got.shape, f"serve (b): {resp['alias']} CPU scores {cpu.shape}")
            worst_cpu = max(worst_cpu, _np_rel(got, cpu))
            rho = min(rho, *(_spearman(g, w) for g, w in zip(got.reshape(SERVE_DAYS, -1),
                                                             cpu.reshape(SERVE_DAYS, -1))))
        errs[rung] = worst
        cpu_errs[rung] = {"max_rel_err": worst_cpu, "min_day_spearman": rho}
        check(worst <= SERVE_TOL, f"serve (b): {rung} fused lanes vs serial {worst} > {SERVE_TOL}")
        if rung == "bfloat16":   # the card's bf16 products round apart from the CPU's
            check(rho >= BF16_SPEARMAN, f"serve (b): bf16 fused lanes vs the CPU: per-day "
                                        f"Spearman {rho} < {BF16_SPEARMAN}")
        else:
            check(worst_cpu <= SERVE_TOL,
                  f"serve (b): {rung} fused lanes vs the CPU {worst_cpu} > {SERVE_TOL}")
    check(launches["gru_fwd"] == 3 and launches["attention_fwd"] == 3
          and all(launches[n] == 0 for n in ("gru_fwd_residuals", "gru_bwd", "gru_dwh",
                                               "attention_bwd")),
          f"serve (b): launches {launches}")

    # the fused tick's wall against S serial dispatches, S = 2, 4, 8, each
    # split by the timeline's spans: dispatch (the scoring call), responses
    # (JSON results and drift digests) and the rest (parsing, bucketing)
    def timed_ticks(groups) -> dict:
        def run():
            t1 = time.perf_counter()
            for al in groups:
                tick(al)
            return (time.perf_counter() - t1) * 1e3
        wall, recs = _serve_timeline(run)
        disp, resp = _span_ms(recs, "serve_dispatch"), _span_ms(recs, "serve_request")
        return {"wall": wall, "dispatch": disp, "responses": resp,
                "rest": wall - disp - resp}

    scaling = {}
    for s in (2, 4, 8):
        al = buckets["float32"][:s]
        tick(al)
        runs = {"fused": [], "serial": []}
        for _ in range(SERVE_SCALING_REPS):
            runs["fused"].append(timed_ticks([al]))
            runs["serial"].append(timed_ticks([[a] for a in al]))
        med = {kind: {part: float(np.median([r[part] for r in rs])) for part in rs[0]}
               for kind, rs in runs.items()}
        scaling[str(s)] = {"fused_tick_ms": med["fused"]["wall"],
                           "serial_ticks_ms": med["serial"]["wall"],
                           "ratio": med["fused"]["wall"] / med["serial"]["wall"],
                           "fused_parts_ms": med["fused"], "serial_parts_ms": med["serial"],
                           "reps": SERVE_SCALING_REPS}
    stack_ms = []
    for _ in range(3):
        daemon._stack_cache.clear()   # the next tick stacks the weights again
        t1 = time.perf_counter()
        tick(buckets["float32"])
        stack_ms.append((time.perf_counter() - t1) * 1e3)
    split = {"fused_8": _device_split(torch, lambda: tick(buckets["float32"])),
             "fused_2": _device_split(torch, lambda: tick(buckets["float32"][:2])),
             "serial_1": _device_split(torch, lambda: tick(["f0"]))}

    # request latency: single days and 34-day ranges, one request per tick
    lat = {"day": [], "range_34": []}
    for i in range(SERVE_LATENCY_N):
        lat["day"].append(daemon.handle({"model": "f0", "day": dates[20 + i % 60]})["latency_ms"])
    for _ in range(SERVE_LATENCY_N):
        r = daemon.handle({"model": "f1", "start": dates[19], "end": dates[52]})
        check(r["ok"] and len(r["results"]) == 34, "serve: the 34-day range")
        lat["range_34"].append(r["latency_ms"])
    latency = {k: _lat_stats(v) for k, v in lat.items()}

    # (c) serve_stall of 50 ms against deadline_ms 20: misses, the breaker,
    # fast-fails, a half-open probe, health degrading and recovering
    sick = ScoringDaemon(registry, dataset, breaker_k=2, breaker_cooldown_s=0.5,
                         health_window=10)
    req = {"model": "f2", "day": dates[50]}
    states, health = [], []
    for _ in range(6):
        states.append(sick.handle(dict(req))["ok"])
    sick.deadline_ms = 20.0
    health.append(sick.health()["status"])
    with chaos.active(ChaosPlan([Fault("serve_stall", times=2, delay_s=0.05)])):
        stalled = [sick.handle(dict(req)) for _ in range(3)]
    health.append(sick.health()["status"])
    check([("deadline exceeded" in (r.get("error") or "")) for r in stalled[:2]] == [True, True]
          and not stalled[2]["ok"] and stalled[2].get("retry_after_s", 0) > 0
          and sick.open_breakers() == [registry.resolve_key("f2")],
          f"serve (c): {stalled}")
    time.sleep(0.55)
    probe = sick.handle(dict(req))
    check(probe["ok"] and sick.open_breakers() == [], f"serve (c): the probe {probe}")
    for _ in range(10):
        sick.handle(dict(req))
    health.append(sick.health()["status"])
    check(health == ["ok", "degraded", "ok"], f"serve (c): health {health}")
    resilience = {"stalled": [{k: r.get(k) for k in ("ok", "error", "retry_after_s",
                                                      "latency_ms")} for r in stalled],
                  "probe_latency_ms": probe["latency_ms"], "health": health,
                  "deadline_misses": sick.deadline_misses,
                  "breaker_fast_fails": sick.breaker_fast_fails}

    # (d) a budget that fits 4 of 6 weights directories: LRU evictions, a
    # cold start bitwise the scores before it, serve_cold_fail healed
    dirs = []
    for i in range(6):
        c = cfg_of(seed + 100 + i)
        dirs.append(save_weights(load_model(c, device="cpu"), c,
                                 os.path.join(work.name, f"w{i}")))
    nb = registry.get("f0").nbytes
    budget = ModelRegistry(device="cuda", budget_bytes=int(4.5 * nb))
    budget.register_checkpoint(dirs[0])
    pre = budget.score("w0", dataset, days32[:4])
    for p in dirs[1:]:
        budget.register_checkpoint(p)
    st = budget.stats()
    check(st["evictions"] == 2 and [e["alias"] for e in st["entries"]] == ["w2", "w3", "w4", "w5"],
          f"serve (d): {st['evictions']} evictions, resident "
          f"{[e['alias'] for e in st['entries']]}")
    t1 = time.perf_counter()
    post = budget.score("w0", dataset, days32[:4])
    cold_ms = (time.perf_counter() - t1) * 1e3
    check(_same_bytes(pre, post) and budget.cold_starts == 1,
          "serve (d): the cold start's scores differ from before the eviction")
    plan = ChaosPlan([Fault("serve_cold_fail")])
    with chaos.active(plan):
        budget.get("w1")
    check(budget.cold_starts == 2 and len(plan.fired) == 1, "serve (d): serve_cold_fail")
    cold = {"budget_bytes": budget.budget_bytes, "entry_bytes": nb,
            "evictions": budget.evictions, "cold_starts": budget.cold_starts,
            "cold_start_ms": cold_ms, "resident": [e["alias"] for e in budget.stats()["entries"]]}

    # (e) POST /admit of a candidate on 5 holdout days while four keep-alive
    # clients send single-day requests through a TickScheduler: the
    # admission runs on the scheduler's admission thread while ticks go on;
    # nothing dropped, each answer from the model serving when it arrived
    live = ModelRegistry(device="cuda")
    inc_key = live.register_checkpoint(dirs[2], alias="prod")
    gate = ScoringDaemon(live, dataset)
    day = dates[60]
    ref = {inc_key: live.score(inc_key, dataset, np.array([60]))[0, :300]}
    sched = TickScheduler(gate, tick_ms=2.0)
    port, srv_thread = _start_front(serve_http, gate, sched)
    stop, answers = threading.Event(), []

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        while not stop.is_set():
            t_in = time.perf_counter()
            status, body = _http(conn, "POST", "/score", {"id": c, "model": "prod", "day": day})
            answers.append((t_in, time.perf_counter(), status, json.loads(body)))
        conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    time.sleep(0.3)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t_admit = time.perf_counter()
    status, body = _http(conn, "POST", "/admit", {
        "path": dirs[3], "alias": "prod", "holdout_days": [int(d) for d in days32[-5:]],
        "min_margin": 1.0})
    t_done = time.perf_counter()
    verdict = json.loads(body)
    time.sleep(0.3)
    stop.set()
    for th in threads:
        th.join(60)
    _http(conn, "POST", "/score", {"cmd": "shutdown"})
    conn.close()
    srv_thread.join(60)
    check(status == 200 and not srv_thread.is_alive() and not any(t.is_alive() for t in threads),
          f"serve (e): POST /admit {status}, the front {srv_thread.is_alive()}")
    cand_key = verdict.get("model")
    check(verdict.get("promoted") and live.resolve_key("prod") == cand_key
          and inc_key not in live.keys(), f"serve (e): {verdict}")
    ref[cand_key] = live.score(cand_key, dataset, np.array([60]))[0, :300]
    check(all(st == 200 and resp["ok"] for _, _, st, resp in answers),
          "serve (e): a request failed")
    # each client's own answers: the incumbent's, then the candidate's
    for c in range(4):
        seq = [resp["model"] for _, _, _, resp in answers if resp["id"] == c]
        flips = sum(1 for a, b in zip(seq, seq[1:]) if a != b)
        check(seq and seq[0] == inc_key and seq[-1] == cand_key and flips == 1,
              f"serve (e): client {c}'s answers flip {flips} times")
    check(all(resp["model"] == cand_key for t_in, _, _, resp in answers if t_in > t_done)
          and all(resp["model"] == inc_key for _, t_out, _, resp in answers if t_out < t_admit),
          "serve (e): an answer from a model that was not serving at its arrival")
    check(all(_same_bytes(_resp_scores(resp), ref[resp["model"]]) for *_, resp in answers),
          "serve (e): an answer's scores differ from its model's")
    # the ticks went on while the admission loaded and scored its gate
    during = [(t_out - t_in) * 1e3 for t_in, t_out, _, _ in answers
              if t_in >= t_admit and t_out <= t_done]
    overlapping = [(t_out - t_in) * 1e3 for t_in, t_out, _, _ in answers
                   if t_in < t_done and t_out > t_admit]
    check(len(during) > 0, "serve (e): no request was answered while the admission ran")
    admit = {"requests": len(answers), "admit_s": t_done - t_admit,
             "answered_during_admit": len(during),
             "wait_ms": _lat_stats([(t_out - t_in) * 1e3 for t_in, t_out, _, _ in answers]),
             "wait_ms_overlapping_admit": _lat_stats(overlapping),
             "verdict": {k: verdict.get(k) for k in (
                 "promoted", "reason", "candidate_rank_ic", "incumbent_rank_ic",
                 "holdout_days")},
             "scheduler": sched.stats()}

    # (f) the threaded HTTP front with concurrent clients
    front = ScoringDaemon(registry, dataset)
    sched = TickScheduler(front, tick_ms=2.0)
    port, srv_thread = _start_front(serve_http, front, sched)
    per_client, http_lat = SERVE_HTTP_PER_CLIENT, []
    lock = threading.Lock()

    def http_client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        for k in range(per_client):
            t1 = time.perf_counter()
            status, body = _http(conn, "POST", "/score",
                                 {"id": k, "model": f"f{(c + k) % SERVE_F32}",
                                  "day": dates[20 + (k % 50)]})
            dt = (time.perf_counter() - t1) * 1e3
            check(status == 200 and json.loads(body)["ok"], f"serve (f): {body[:200]}")
            with lock:
                http_lat.append(dt)
        conn.close()

    clients = [threading.Thread(target=http_client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for th in clients:
        th.start()
    for th in clients:
        th.join(300)
    http_s = time.perf_counter() - t1
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    _, metrics = _http(conn, "GET", "/metrics")
    status, healthz = _http(conn, "GET", "/healthz")
    _http(conn, "POST", "/score", {"cmd": "shutdown"})
    conn.close()
    srv_thread.join(60)
    n_http = 8 * per_client
    check(len(http_lat) == n_http and status == 200 and not srv_thread.is_alive(),
          f"serve (f): {len(http_lat)} answers, /healthz {status}")
    check(f"factorvae_serve_request_latency_seconds_count {n_http}" in metrics
          and 'factorvae_compile_total{kind="compile"}' in metrics,
          "serve (f): the /metrics scrape")
    http_out = {"requests": n_http, "clients": 8, "seconds": http_s,
                "requests_per_s": n_http / http_s, **_lat_stats(http_lat),
                "scheduler": sched.stats(), "healthz": json.loads(healthz)["status"],
                "fused_requests": front.fused_requests, "dispatches": front.dispatches,
                "metrics_bytes": len(metrics)}

    # (g) the serve CLI's --batch as a subprocess on the card, equal to the
    # same requests in this process
    reqs = [{"id": 1, "model": "w0", "start": dates[40], "end": dates[71]},
            {"id": 2, "model": "w1", "start": dates[40], "end": dates[71]},
            {"id": 3, "model": "w1", "day": dates[60], "top": 10}, {"id": 4, "cmd": "ping"}]
    req_file = os.path.join(work.name, "reqs.jsonl")
    with open(req_file, "w") as fh:
        fh.write("\n".join(json.dumps(r) for r in reqs) + "\n")
    out_file = os.path.join(work.name, "out.jsonl")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "factorvae_tpu_torch.serve", "--model", dirs[0], "--model",
         dirs[1], "--synthetic", "80,300", "--seed", str(seed), "--batch", req_file,
         "--out", out_file], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t1
    check(proc.returncode == 0, f"serve (g): the CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    with open(out_file) as fh:
        got = [json.loads(line) for line in fh]
    inproc = ModelRegistry(device="cuda")
    for p in dirs[:2]:
        inproc.register_checkpoint(p)
    import io

    sink = io.StringIO()
    serve_batch_file(ScoringDaemon(inproc, dataset), req_file, sink)
    want_cli = [json.loads(line) for line in sink.getvalue().splitlines()]

    def strip(r):
        return {k: v for k, v in r.items() if k != "latency_ms"}

    check([strip(r) for r in got] == [strip(r) for r in want_cli]
          and [r.get("batched_with") for r in got[:2]] == [2, 2],
          "serve (g): the CLI's responses differ from in-process handle_batch")
    work.cleanup()

    return {"phase": "serve", "card": card,
            "config": "flagship C158/T20/H64/K96/M128 on the 80-day panel of 300 stocks",
            "models": {"float32": SERVE_F32, "bfloat16": 2, "int8": 2},
            "admit_s": admit_s, "warmup_s": warm, "launches": launches,
            "buckets": per_bucket, "fused_vs_serial_max_rel_err": errs,
            "tolerance": SERVE_TOL, "kernel_vs_plain": kernel_errs,
            "fused_vs_cpu": cpu_errs, "scaling": scaling, "restack_tick_ms": stack_ms,
            "device_split": split, "latency": latency, "resilience": resilience,
            "budget": cold, "admit": admit, "http": http_out,
            "cli": {"seconds": cli_s, "responses": len(got)}}


POOL_TOL = 1e-5            # artifact / routed scores vs the in-process path, max |a - b| / max(1, max |b|)
POOL_MODELS = 4            # weights directories the fleets serve (one per worker at 4 workers)
POOL_LOAD_CLIENTS = 8      # keep-alive clients of the load runs
POOL_LOAD_PER_CLIENT = 75      # 600 requests a load run (150 before the wide phase)
POOL_REPS = 5              # artifact and in-process 32-day requests timed, medians kept


def _worker_launches(urls) -> dict:
    """Kernel launches summed over the workers' own counters (`/stats`)."""
    from factorvae_tpu_torch.serve.pool import http_json

    out: dict = {}
    for url in urls:
        for name, n in http_json(url + "/stats", timeout=60)["kernel_launches"].items():
            out[name] = out.get(name, 0) + n
    return out


def _worker_memory(urls) -> list:
    from factorvae_tpu_torch.serve.pool import http_json

    return [http_json(url + "/stats", timeout=60)["panel"]["memory_reserved"] for url in urls]


class _SmiSampler:
    """`nvidia-smi` every 200 ms while it runs: utilization.gpu (the share of
    time a kernel of any process ran), the SM clock and the power draw. A
    yardstick for the load runs, not a check."""

    def __init__(self):
        import threading

        self.rows, self.proc, self.thread = [], None, None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu,clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "200"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return             # no nvidia-smi: stop() reports no samples
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue

    def stop(self) -> dict:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait(timeout=30)
            self.thread.join(timeout=30)
        rows = np.asarray(self.rows[1:])    # the first sample may predate the load
        if rows.ndim != 2 or len(rows) == 0:
            return {"error": "nvidia-smi gave no samples"}
        return {"gpu_util_pct_mean": float(rows[:, 0].mean()),
                "sm_clock_mhz_median": float(np.median(rows[:, 1])),
                "power_w_mean": float(rows[:, 2].mean()), "samples": int(len(rows))}


def _daemon_counts(urls) -> dict:
    """Requests served, dispatches, fused requests and ticks summed over the
    daemons at `urls` (`/stats`)."""
    from factorvae_tpu_torch.serve.pool import http_json

    out = dict.fromkeys(("requests_served", "dispatches", "fused_requests", "ticks"), 0)
    for url in urls:
        st = http_json(url + "/stats", timeout=60)
        for k in out:
            out[k] += st[k]
    return out


def _load_run(port, dates, clients, per_client, what: str, sample: bool = False,
              daemons=()) -> dict:
    """`clients` keep-alive clients, `per_client` single-day requests each,
    the models in turn: requests/s and latency, with `sample` the card's
    utilization meanwhile, and what the daemons at `daemons` did for them
    (dispatches, fused requests, ticks); every answer must be ok."""
    import http.client
    import threading

    lat, fails, lock = [], [], threading.Lock()

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        for k in range(per_client):
            t1 = time.perf_counter()
            status, body = _http(conn, "POST", "/score",
                                 {"id": k, "model": f"m{(c + k) % POOL_MODELS}",
                                  "day": dates[20 + (k % 50)]})
            dt = (time.perf_counter() - t1) * 1e3
            with lock:
                lat.append(dt)
                if status != 200 or not json.loads(body).get("ok"):
                    fails.append(body[:200])
        conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    before = _daemon_counts(daemons)
    smi = _SmiSampler() if sample else None
    t1 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    seconds = time.perf_counter() - t1
    card = smi.stop() if smi is not None else None
    after = _daemon_counts(daemons)
    check(not fails and len(lat) == clients * per_client and not any(
        th.is_alive() for th in threads), f"pool (c) {what}: {len(fails)} failed: {fails[:2]}")
    return {"requests": len(lat), "clients": clients, "seconds": seconds,
            "requests_per_s": len(lat) / seconds, **_lat_stats(lat), "card": card,
            "daemons": {k: after[k] - before[k] for k in after}}


class _Hammer:
    """Keep-alive clients sending single-day requests until stopped; each
    answer kept as (t_in, t_out, status, response)."""

    def __init__(self, port, requests, clients=4):
        import http.client
        import threading

        self.answers, self._stop = [], threading.Event()

        def run(c):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            k = 0
            while not self._stop.is_set():
                req = dict(requests[(c + k) % len(requests)], id=c)
                t_in = time.perf_counter()
                try:
                    status, body = _http(conn, "POST", "/score", req)
                    resp = json.loads(body)
                except (OSError, ValueError) as e:
                    status, resp = 0, {"ok": False, "error": f"client: {e}"}
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                self.answers.append((t_in, time.perf_counter(), status, resp))
                k += 1
            conn.close()

        self.threads = [threading.Thread(target=run, args=(c,)) for c in range(clients)]
        for th in self.threads:
            th.start()

    def stop(self) -> list:
        self._stop.set()
        for th in self.threads:
            th.join(120)
        check(not any(th.is_alive() for th in self.threads), "pool: a client hung")
        return [a for a in self.answers if a[2] != 200 or not a[3].get("ok")]


def _wait_for(cond, timeout_s: float, what: str, step: float = 0.05) -> float:
    """Seconds until `cond()` holds; a failed check after `timeout_s`."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout_s, f"pool: {what} within {timeout_s:g}s")
        time.sleep(step)
    return time.perf_counter() - t0


def _family_heads_unique(text: str) -> bool:
    heads = [ln for ln in text.splitlines() if ln.startswith(("# HELP", "# TYPE"))]
    return len(heads) == len(set(heads)) and len(heads) > 0


def phase_pool(torch, seed: int, counters, card: str) -> dict:
    """The serving fleet at flagship width on the 80-day panel (see the
    module docstring, phase 14)."""
    import http.client
    import tempfile

    from factorvae_tpu_torch import chaos
    from factorvae_tpu_torch.chaos import ChaosPlan, Fault
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.export_aot import export_prediction
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.ops.kernels import plain
    from factorvae_tpu_torch.ops.kernels.attention import attention_fwd_plain
    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd_plain
    from factorvae_tpu_torch.params import save_weights
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon, TickScheduler, serve_http
    from factorvae_tpu_torch.serve.pool import WorkerPool, free_port, http_json, http_text
    from factorvae_tpu_torch.serve.registry import ModelRegistry
    from factorvae_tpu_torch.serve.router import Router

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()     # the earlier phases' cached blocks, for the workers
    repo = os.path.dirname(os.path.abspath(__file__))
    base = get_preset("flagship")
    m = base.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    dates = [str(d) for d in dataset.dates]
    days32 = dataset.split_days(dates[40], dates[71])
    check(len(days32) == 32 and dataset.n_max == 304, "pool: the 32-day request")
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_pool_")

    def cfg_of(s):
        return dataclasses.replace(base, train=dataclasses.replace(base.train, seed=s))

    dirs = [save_weights(load_model(cfg_of(seed + 300 + i), device="cpu"), cfg_of(seed + 300 + i),
                         os.path.join(work.name, "weights", f"m{i}"))
            for i in range(POOL_MODELS + 2)]
    inproc = ModelRegistry(device="cuda")
    for i, p in enumerate(dirs):
        inproc.register_checkpoint(p, alias=f"m{i}")
    inproc.register_checkpoint(dirs[0], precision="int8", alias="m0q")

    # (a) artifacts: f32 and int8 exported on the CPU, loaded on the card
    c0 = cfg_of(seed + 300)
    cpu_model = load_model(c0, dirs[0], device="cpu")
    arts, sizes, export_s, load_ms = {}, {}, {}, {}
    reg = ModelRegistry(device="cuda")
    for rung, int8 in (("float32", False), ("int8", True)):
        t1 = time.perf_counter()
        blob = export_prediction(cpu_model, c0, dataset.n_max, int8=int8, platform="cuda")
        export_s[rung] = time.perf_counter() - t1
        arts[rung] = os.path.join(work.name, f"a_{rung}")
        with open(arts[rung], "wb") as fh:
            fh.write(blob)
        sizes[rung] = len(blob)
        t1 = time.perf_counter()
        reg.register_artifact(arts[rung], alias=rung)
        load_ms[rung] = (time.perf_counter() - t1) * 1e3
        reg.score(rung, dataset, days32[:1])             # the first call
    torch.cuda.synchronize()
    want = {"float32": inproc.score("m0", dataset, days32),
            "int8": inproc.score("m0q", dataset, days32)}
    got, per_rung, seen = {}, {}, []
    tag = {"rung": None}
    real = _recording(seen, tag)
    try:
        for rung in ("float32", "int8"):
            tag["rung"] = rung
            for c in counters:
                c.launches = 0
            got[rung] = reg.score(rung, dataset, days32)
            torch.cuda.synchronize()
            per_rung[rung] = {c.__name__: c.launches for c in counters}
    finally:
        _restore(real)
    launches_artifact = per_rung["float32"]
    for rung, ls in per_rung.items():
        check(ls["gru_fwd"] == 32 and ls["attention_fwd"] == 32
              and all(n == 0 for k, n in ls.items() if k not in ("gru_fwd", "attention_fwd")),
              f"pool (a): the {rung} artifact's 32-day request launched {ls}")
    plain_fn = {"gru_fwd": gru_fwd_plain, "attention_fwd": attention_fwd_plain}
    kernel_errs: dict = {}
    with torch.inference_mode():
        for rung, name, args, out in seen:
            ref = plain(plain_fn[name], args[0].ndim == 4, *args)
            key = f"{rung}/{name}"
            e = kernel_errs.setdefault(key, {"max_abs_err": 0.0, "launches": 0,
                                             "shape": list(args[0].shape)})
            e["max_abs_err"] = max(e["max_abs_err"], float((out - ref).abs().max()))
            e["launches"] += 1
    del seen
    for key, e in kernel_errs.items():
        tol = K1_TOL if key.endswith("gru_fwd") else K4_TOL
        check(e["launches"] == 32 and e["max_abs_err"] <= tol,
              f"pool (a): {key} vs its plain version {e} > {tol}")
    vs_inproc = {r: _np_rel(got[r][:, :300], want[r][:, :300]) for r in got}
    for r, e in vs_inproc.items():
        check(bool(np.isfinite(got[r][:, :300]).all()) and e <= POOL_TOL,
              f"pool (a): the {r} artifact vs the in-process path {e} > {POOL_TOL}")
    cpu_reg = ModelRegistry(device="cpu")
    cpu_reg.register_artifact(arts["float32"], alias="a")
    cpu_scores = cpu_reg.score("a", PanelDataset(panel, seq_len=m.seq_len, device="cpu"), days32)
    vs_cpu = _np_rel(got["float32"][:, :300], cpu_scores[:, :300])
    check(vs_cpu <= POOL_TOL, f"pool (a): the artifact on the card vs on the CPU {vs_cpu}")

    def med_ms(fn):
        ts = []
        for _ in range(POOL_REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(ts))

    latency = {"artifact_32_days_ms": med_ms(lambda: reg.score("float32", dataset, days32)),
               "inprocess_32_days_ms": med_ms(lambda: inproc.score("m0", dataset, days32)),
               "artifact_int8_32_days_ms": med_ms(lambda: reg.score("int8", dataset, days32)),
               "artifact_1_day_ms": med_ms(lambda: reg.score("float32", dataset, days32[:1])),
               "inprocess_1_day_ms": med_ms(lambda: inproc.score("m0", dataset, days32[:1])),
               "launches_per_32_days": {"artifact": 32, "inprocess": 1}}
    artifact = {"bytes": sizes, "export_s_cpu": export_s, "load_ms": load_ms,
                "launches": per_rung, "kernel_vs_plain": kernel_errs,
                "vs_inprocess_max_rel_err": vs_inproc, "vs_cpu_max_rel_err": vs_cpu,
                "tolerance": POOL_TOL, "latency": latency}
    print(f"[pool] (a) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)

    # (b) the fleet's CLI: 2 workers and the router over the weights
    # directories; the router's process exports the store on the CPU
    store = os.path.join(work.name, "store")
    rport = free_port()
    router_url = f"http://127.0.0.1:{rport}"
    cmd = [sys.executable, "-m", "factorvae_tpu_torch.serve"]
    for p in dirs[:POOL_MODELS]:
        cmd += ["--model", p]
    cmd += ["--synthetic", "80,300", "--seed", str(seed), "--workers", "2",
            "--router_port", str(rport), "--aot_store", store,
            "--metrics_jsonl", os.path.join(work.name, "fleet.jsonl")]
    log_path = os.path.join(work.name, "pool_cli.log")
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=repo)

    def fleet_up():
        if proc.poll() is not None:
            with open(log_path) as fh:
                check(False, f"pool (b): the fleet's CLI exited {proc.returncode}: "
                             f"{fh.read()[-2000:]}")
        try:
            return http_json(router_url + "/healthz", timeout=2)["workers_healthy"] == 2
        except Exception:      # noqa: BLE001 - not listening yet
            return False

    try:
        start_s = _wait_for(fleet_up, 400, "the fleet's CLI answering with 2 workers", 0.2)
        stats = http_json(router_url + "/stats", timeout=60)
        workers = stats["pool"]["workers"]
        urls = [w["url"] for w in workers]
        check(stats["router"]["cuda_initialized"] is False,
              "pool (b): the router's process made a CUDA context")
        check([w["worker_id"] for w in workers] == ["w0", "w1"]
              and all(w["metrics"] == w["url"] + "/metrics" and w["stats"] == w["url"] + "/stats"
                      for w in workers), f"pool (b): /stats workers {workers}")
        compile_w1 = {kind: float(line.rsplit(" ", 1)[1])
                      for kind in ("compile", "compile_cached")
                      for line in http_text(urls[1] + "/metrics").splitlines()
                      if line.startswith(f'factorvae_compile_total{{kind="{kind}"}}')}
        check(compile_w1.get("compile") == 0 and compile_w1.get("compile_cached", 0) >= 2,
              f"pool (b): worker 1's build taxonomy {compile_w1}")
        reqs = [{"id": i, "model": f"m{i}", "start": dates[40], "end": dates[71]}
                for i in range(POOL_MODELS)]
        before = _worker_launches(urls)
        t1 = time.perf_counter()
        routed = http_json(router_url + "/score", reqs, timeout=300)
        routed_ms = (time.perf_counter() - t1) * 1e3
        after = _worker_launches(urls)
        launches_pool = {k: after[k] - before[k] for k in after}
        check(launches_pool["gru_fwd"] > 0 and launches_pool["attention_fwd"] > 0
              and all(n == 0 for k, n in launches_pool.items()
                      if k not in ("gru_fwd", "attention_fwd")),
              f"pool (b): the workers' launches {launches_pool}")
        routed_err = 0.0
        for i, resp in enumerate(routed):
            check(resp["ok"], f"pool (b): {resp.get('error')}")
            ref = inproc.score(f"m{i}", dataset, days32)[:, :300].reshape(-1)
            routed_err = max(routed_err, _np_rel(_resp_scores(resp), ref))
        check(routed_err <= POOL_TOL, f"pool (b): routed vs in-process {routed_err}")
        owners = {r["model"]: r["worker"] for r in routed}
        for _ in range(3):
            again = http_json(router_url + "/score",
                              [{"model": f"m{i}", "day": dates[60]} for i in range(POOL_MODELS)])
            check({r["model"]: r["worker"] for r in again} == owners,
                  "pool (b): a key moved to another worker")
        merged = http_text(router_url + "/metrics")
        check(_family_heads_unique(merged)
              and all(f'factorvae_serve_ticks_total{{worker_id="{w}"}}' in merged
                      for w in ("w0", "w1")), "pool (b): the merged /metrics")
        memory_b = _worker_memory(urls)
        collected = _collect_fleet_check(router_url)
        pids = [w["pid"] for w in workers]
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=30)
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    check(rc == 0 and not alive, f"pool (b): SIGTERM left rc {rc}, live workers {alive}")
    check(all(os.path.isfile(os.path.join(store, f"m{i}")) for i in range(POOL_MODELS)),
          "pool (b): the store's artifacts")
    cli_fleet = {"start_s": start_s, "workers": 2, "compile_w1": compile_w1,
                 "routed_4x32_days_ms": routed_ms, "routed_vs_inprocess_max_rel_err": routed_err,
                 "owners": owners, "memory_reserved": memory_b,
                 "metrics_bytes": len(merged), "router_cuda_initialized": False,
                 "collect": collected}
    print(f"[pool] (b) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)

    # (c) load: the router over 1, 2 and 4 workers, then the single daemon
    load = {}
    for n in (1, 2, 4):
        pool = WorkerPool(dirs[:POOL_MODELS], ["--synthetic", "80,300"], n, store,
                          work_dir=os.path.join(work.name, f"load{n}"), device="cuda",
                          extra_args=["--seed", str(seed)])
        router = Router(pool, hedge=False)
        try:
            t1 = time.perf_counter()
            pool.start()
            up_s = time.perf_counter() - t1
            port = router.start()
            _load_run(port, dates, POOL_LOAD_CLIENTS, 4, f"{n} workers' warm-up")
            run = _load_run(port, dates, POOL_LOAD_CLIENTS, POOL_LOAD_PER_CLIENT,
                            f"{n} workers", sample=True,
                            daemons=[w.url for w in pool.workers])
            run.update(start_s=up_s, memory_reserved=_worker_memory([w.url for w in
                                                                      pool.workers]),
                       router=router.stats()["router"])
            load[str(n)] = run
        finally:
            router.stop()
    sport = free_port()
    cmd = [sys.executable, "-m", "factorvae_tpu_torch.serve"]
    for p in dirs[:POOL_MODELS]:
        cmd += ["--model", p]
    cmd += ["--synthetic", "80,300", "--seed", str(seed), "--http", str(sport), "--scheduler",
            "--warmup"]
    single = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                              cwd=repo)
    try:
        def single_up():
            check(single.poll() is None, "pool (c): the single daemon exited")
            try:
                return http_json(f"http://127.0.0.1:{sport}/healthz", timeout=2)["ok"]
            except Exception:      # noqa: BLE001 - not listening yet
                return False

        _wait_for(single_up, 300, "the single daemon", 0.2)
        _load_run(sport, dates, POOL_LOAD_CLIENTS, 4, "the single daemon's warm-up")
        load["single_daemon"] = _load_run(sport, dates, POOL_LOAD_CLIENTS,
                                          POOL_LOAD_PER_CLIENT, "the single daemon",
                                          sample=True,
                                          daemons=[f"http://127.0.0.1:{sport}"])
        load["single_daemon"]["memory_reserved"] = _worker_memory(
            [f"http://127.0.0.1:{sport}"])
    finally:
        single.terminate()
        single.wait(timeout=120)
    print(f"[pool] (c) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)

    # (d) kill_worker under load, on a pool over the store's artifacts
    arts4 = [os.path.join(store, f"m{i}") for i in range(POOL_MODELS)]
    pool = WorkerPool(arts4, ["--synthetic", "80,300"], 2, store,
                      work_dir=os.path.join(work.name, "chaos"), device="cuda",
                      extra_args=["--seed", str(seed)], health_interval_s=0.2)
    router = Router(pool, hedge=False)
    try:
        pool.start()
        rport = router.start()
        probe = [{"model": f"m{i}", "day": dates[50]} for i in range(POOL_MODELS)]
        before = http_json(f"http://127.0.0.1:{rport}/score", probe, timeout=300)
        victim = pool.worker("w1")
        vkeys = [r["model"] for r in before if r["worker"] == "w1"]
        check(vkeys and all(r["ok"] for r in before), f"pool (d): worker 1 owns {vkeys}")
        port_before = victim.port
        hammer = _Hammer(rport, probe, clients=4)
        time.sleep(0.5)
        plan = ChaosPlan([Fault("kill_worker", request=victim.index)])
        with chaos.active(plan):
            _wait_for(lambda: plan.fired, 30, "kill_worker firing", 0.005)
            t_kill = time.perf_counter()
            mttr = _wait_for(lambda: victim.restarts == 1 and victim.state == "ok", 300,
                             "the killed worker healthy again", 0.02)
        time.sleep(0.5)
        failed = hammer.stop()
        n_answers = len(hammer.answers)
        during = [a for a in hammer.answers if t_kill <= a[0] <= t_kill + mttr]
        rerouted = [a for a in during if a[3].get("worker") == "w0"
                    and a[3].get("model") in vkeys]
        # the killed worker's own answers now: its keys moved to worker 0
        # while it was down, so ask it directly
        vidx = [i for i, r in enumerate(before) if r["worker"] == "w1"]
        after = http_json(victim.url + "/score", [probe[i] for i in vidx], timeout=300)
        after = after if isinstance(after, list) else [after]
        check(not failed, f"pool (d): {len(failed)} failed requests: {failed[:2]}")
        check(rerouted and victim.respawn_source == "aot_store" and victim.port == port_before,
              f"pool (d): rerouted {len(rerouted)}, source {victim.respawn_source}")
        check([a["results"] for a in after]
              == [before[i]["results"] for i in vidx],
              "pool (d): the respawned worker's scores differ from before the kill")
        # how much of the MTTR a bare process that imports torch and makes
        # its CUDA context takes
        t1 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import torch; torch.zeros(1, device='cuda'); "
                        "torch.cuda.synchronize()"], check=True, timeout=300)
        bare_start_s = time.perf_counter() - t1
        kill = {"mttr_s": mttr, "bare_cuda_process_s": bare_start_s,
                "requests": n_answers, "failed": 0,
                "answered_while_down": len(during), "rerouted": len(rerouted),
                "router": {k: router.stats()["router"][k]
                           for k in ("reroutes", "proxy_errors", "requests")},
                "respawn_source": victim.respawn_source, "port_kept": True}
        print(f"[pool] (d) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)

        # (e) the control plane: admit fan-out, scaling, a remote join and
        # its kill, a rolling upgrade, then a hedged forward
        days5 = [int(d) for d in days32[-5:]]
        boot = pool.admit_fanout({"path": dirs[POOL_MODELS], "alias": "prod"})
        check(boot["ok"] and all(w["promoted"] for w in boot["workers"]),
              f"pool (e): the bootstrap admission {boot}")
        prod = [{"model": "prod", "day": dates[60]}]
        hammer = _Hammer(rport, prod, clients=4)
        time.sleep(0.5)
        t1 = time.perf_counter()
        flip = pool.admit_fanout({"path": dirs[POOL_MODELS + 1], "alias": "prod",
                                  "holdout_days": days5, "min_margin": 1.0})
        admit_s = time.perf_counter() - t1
        time.sleep(0.5)
        failed = hammer.stop()
        admit_requests = len(hammer.answers)
        check(not failed and flip["ok"] and all(w["promoted"] for w in flip["workers"])
              and len(flip["workers"]) == 2, f"pool (e): the admission {flip} {failed[:2]}")
        inc, cand = boot["workers"][0]["model"], flip["workers"][0]["model"]
        for c in range(4):
            seq = [a[3]["model"] for a in hammer.answers if a[3].get("id") == c]
            flips = sum(1 for x, y in zip(seq, seq[1:]) if x != y)
            check(seq and seq[0] == inc and seq[-1] == cand and flips == 1,
                  f"pool (e): client {c}'s answers flip {flips} times")
        t1 = time.perf_counter()
        w2 = pool.scale_up()
        up_s = time.perf_counter() - t1
        check(w2 is not None and len(pool.healthy_ids()) == 3
              and w2.respawn_source == "aot_store", "pool (e): scale_up to 3")
        down = pool.scale_down()
        check(down is w2 and len(pool.workers) == 2 and w2.proc.poll() is not None,
              "pool (e): scale_down to 2")
        pool.router_url = f"http://127.0.0.1:{rport}"
        t1 = time.perf_counter()
        agent = pool.launch_remote()
        _wait_for(lambda: agent.capability is not None and agent.state == "ok", 300,
                  "the remote agent registered", 0.05)
        join_s = time.perf_counter() - t1
        check(agent.capability == pool.store.capability_digest(),
              "pool (e): the agent's capability digest")
        agent_store = os.path.join(pool.work_dir, f"r{agent.index}_store")
        man = {a["alias"]: a["sha256"] for a in pool.store.manifest()}
        from factorvae_tpu_torch.serve.pool import file_sha256

        check(sorted(man) == sorted(n for n in os.listdir(agent_store)
                                    if not n.endswith(".meta.json"))
              and all(file_sha256(os.path.join(agent_store, a)) == s for a, s in man.items()),
              "pool (e): the agent's downloads")
        via_agent = http_json(agent.url + "/score", probe[0], timeout=300)
        via_w0 = http_json(pool.worker("w0").url + "/score", probe[0], timeout=300)
        check(via_agent["ok"] and via_agent["results"] == via_w0["results"],
              "pool (e): the remote agent's scores differ from worker 0's")
        agent.capability = None
        plan = ChaosPlan([Fault("kill_remote_worker", request=agent.index)])
        with chaos.active(plan):
            _wait_for(lambda: plan.fired, 30, "kill_remote_worker firing", 0.005)
            t_kill = time.perf_counter()
            rejoin_s = _wait_for(lambda: agent.restarts == 1 and agent.state == "ok"
                                 and agent.capability is not None, 300,
                                 "the remote agent's re-join", 0.05)
        check(pool.stats()["remote_kills"] == 1 and agent.respawn_source == "artifact_service",
              "pool (e): kill_remote_worker")
        pool.deregister(agent.wid)
        hammer = _Hammer(rport, probe, clients=4)
        t1 = time.perf_counter()
        started = http_json(f"http://127.0.0.1:{rport}/upgrade", {}, timeout=60)
        _wait_for(lambda: (http_json(f"http://127.0.0.1:{rport}/stats", timeout=60)
                           .get("last_upgrade") or {}).get("ok") is not None, 600,
                  "the rolling upgrade", 0.2)
        upgrade_s = time.perf_counter() - t1
        time.sleep(0.5)
        failed = hammer.stop()
        upgrade = http_json(f"http://127.0.0.1:{rport}/stats", timeout=60)["last_upgrade"]
        check(started["ok"] and upgrade["ok"] and len(upgrade["workers"]) == 2 and not failed,
              f"pool (e): the rolling upgrade {upgrade}, {len(failed)} failed: {failed[:2]}")
        control = {"admit_s": admit_s, "admit_requests": admit_requests,
                   "scale_up_s": up_s, "remote_join_s": join_s,
                   "remote_rejoin_s": rejoin_s, "upgrade_s": upgrade_s,
                   "upgrade": upgrade, "upgrade_requests": len(hammer.answers),
                   "failed": 0}
    finally:
        router.stop()

    # a hedged forward: two daemons on the card behind a router, the key's
    # owner stalled by serve_stall; the duplicate's answer wins, counted once
    hreg = ModelRegistry(device="cuda")
    hreg.register_checkpoint(dirs[0], alias="m0")
    fronts = []
    for _ in range(2):
        d = ScoringDaemon(hreg, dataset)
        fronts.append((d,) + _start_front(serve_http, d, TickScheduler(d, tick_ms=2.0)))
    hpool = WorkerPool([], ["--synthetic", "80,300"], 1, os.path.join(work.name, "hstore"),
                       work_dir=os.path.join(work.name, "hedge"), device="cuda")
    hws = [hpool.adopt_remote("127.0.0.1", port) for _, port, _ in fronts]
    hrouter = Router(hpool, hedge_ms=50.0)
    hrouter._assign["m0"] = hws[0].wid
    hport = hrouter.start()
    try:
        with chaos.active(ChaosPlan([Fault("serve_stall", delay_s=1.0)])):
            t1 = time.perf_counter()
            won = http_json(f"http://127.0.0.1:{hport}/score",
                            {"id": 1, "model": "m0", "day": dates[60]}, timeout=60)
            hedge_ms = (time.perf_counter() - t1) * 1e3
            time.sleep(1.2)        # the stalled leg lands and is discarded
        hs = hrouter.stats()["router"]
        check(won["ok"] and won["worker"] == hws[1].wid and hedge_ms < 1000
              and (hs["requests"], hs["forwarded"]) == (1, 1)
              and hs["hedge"]["hedges"] == 1 and hs["hedge"]["hedge_wins"] == 1
              and hrouter.lat_hist.count == 1 and hs["proxy_errors"] == 0,
              f"pool (e): the hedged forward {hs} in {hedge_ms}ms")
        hedge = {"answer_ms": hedge_ms, "stall_ms": 1000.0, "hedge_delay_ms": 50.0,
                 "router": {k: hs[k] for k in ("requests", "forwarded", "proxy_errors")},
                 "hedges": hs["hedge"]["hedges"], "hedge_wins": hs["hedge"]["hedge_wins"]}
    finally:
        hrouter.stop(stop_pool=False)
        for d, port, th in fronts:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            _http(conn, "POST", "/score", {"cmd": "shutdown"})
            conn.close()
            th.join(60)
    work.cleanup()
    return {"phase": "pool", "card": card,
            "config": "flagship C158/T20/H64/K96/M128 on the 80-day panel of 300 stocks",
            "launches_artifact": launches_artifact, "launches_pool": launches_pool,
            "artifact": artifact, "cli_fleet": cli_fleet, "load": load, "kill": kill,
            "control": control, "hedge": hedge, "seconds": time.perf_counter() - t_phase}


STACKED_LAYERS = 2


def _bias_terms(model) -> tuple:
    """({bias name: per entry, the sum of |output gradient| over the rows
    the backward adds into it}, the hooks' handles) for every `Dense` layer
    of `model`, filled by its next backward."""
    from factorvae_tpu_torch.models.layers import Dense

    terms, handles = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            def add(g, key=f"{name}.bias"):
                terms[key] = terms.get(key, 0) + g.detach().abs().reshape(
                    -1, g.shape[-1]).sum(0).cpu()

            def watch(m, args, out, add=add):
                out.register_hook(add)

            handles.append(mod.register_forward_hook(watch))
    return terms, handles


def _grads_vs_cpu(torch, g_gpu: dict, g_cpu: dict, what: str = "stacked",
                  terms: dict = None) -> tuple:
    """Per-parameter max |a - b| / max |b| of two gradient sets, leaving out
    what is zero up to rounding on the CPU, as the train phase does: whole
    parameters, and the rows of ZERO_GRAD_ROWS (the key bias of a head whose
    valid scores are all positive). Those are held to ZERO_GRAD_ATOL on the
    card instead. With the CPU step's bias `terms` (`_bias_terms`), a bias
    entry's difference is taken over the larger of max |b| and the sum of
    its terms' magnitudes x SUM_RTOL / TRAIN_GRAD_RTOL. Returns (errors,
    zero parameters, {name: the zero rows, their largest card gradient, and
    the parameter's error with them in}, {bias: its largest cancellation
    and its error against max |b| alone})."""
    g_max = {k: float(g.abs().max()) for k, g in g_cpu.items()}
    zero = sorted(k for k, v in g_max.items() if v <= ZERO_GRAD_ATOL)
    for k in zero:
        check(float(g_gpu[k].abs().max()) <= ZERO_GRAD_ATOL,
              f"{what}: {k} (zero gradient on the CPU) has |g| "
              f"{float(g_gpu[k].abs().max())} on the card")
    errs, zero_rows, cancelled = {}, {}, {}
    for k in g_cpu:
        if k in zero:
            continue
        diff = (g_gpu[k] - g_cpu[k]).abs()
        errs[k] = float(diff.max()) / g_max[k]
        if terms and k in terms:
            scale = torch.clamp(terms[k] * (SUM_RTOL / TRAIN_GRAD_RTOL), min=g_max[k])
            kappa = float((terms[k] / g_cpu[k].abs().clamp(min=1e-30)).max())
            if kappa >= TRAIN_GRAD_RTOL / SUM_RTOL:
                cancelled[k] = {"kappa_max": kappa, "err_against_max": errs[k]}
            errs[k] = float((diff / scale).max())
            continue
        rows = _row_max(g_cpu[k]) <= ZERO_GRAD_ATOL if k in ZERO_GRAD_ROWS else None
        if rows is None or not bool(rows.any()):
            continue
        card = float(_row_max(g_gpu[k])[rows].max())
        check(card <= ZERO_GRAD_ATOL, f"{what}: {k}'s {int(rows.sum())} zero rows on the "
                                      f"CPU have |g| {card} on the card")
        zero_rows[k] = {"rows": int(rows.sum()), "of": int(rows.numel()),
                        "card_grad_max": card, "err_with_rows": errs[k]}
        errs[k] = float(_row_max(diff)[~rows].max()) / g_max[k]
    return errs, zero, zero_rows, cancelled


def phase_stacked(torch, seed: int, counters, card: str) -> dict:
    """The stacked GRU at flagship width, L = 2 (the module docstring's
    phase 15)."""
    import tempfile

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    base = get_preset("flagship")
    panel = synthetic_panel_dense(80, 300, base.model.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_stacked_")

    def cfg_of(layers, **model):
        return dataclasses.replace(
            base, model=dataclasses.replace(base.model, gru_layers=layers, **model),
            data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                     val_start_time=dates[50], val_end_time=dates[69]),
            train=dataclasses.replace(base.train, seed=seed, num_epochs=1, days_per_step=1,
                                      checkpoint_every=0,
                                      save_dir=os.path.join(work.name, f"l{layers}")))

    dataset = PanelDataset(panel, seq_len=base.model.seq_len, device="cuda")
    cpu_ds = PanelDataset(panel, seq_len=base.model.seq_len, device="cpu")
    # (a) one deterministic training step and a no-grad forward, card and CPU,
    # from the same weights
    det = cfg_of(STACKED_LAYERS, dropout_rate=0.0, recon_loss="nll")
    runs = {}
    for device, ds in (("cuda", dataset), ("cpu", cpu_ds)):
        tr = Trainer(det, ds, device=device)
        st = tr.init_state()
        order = tr._order(tr.train_days, True, 0)
        x, _, _ = ds.gather(order[0])
        with torch.no_grad():
            for c in counters:
                c.launches = 0
            latent = st.model.feature_extractor(x.reshape(-1, *x.shape[2:]))
            forward = {c.__name__: c.launches for c in counters}
            for c in counters:
                c.launches = 0
        aux = train_step(st, ds, order[0], guard=True)
        step = {c.__name__: c.launches for c in counters}
        runs[device] = (latent.cpu(), float(aux["loss_sum"] / aux["days"]),
                        {k: p.grad.detach().cpu() for k, p in st.model.named_parameters()},
                        forward, step)
    (lat_g, loss_g, g_gpu, fwd_launch, step_launch), (lat_c, loss_c, g_cpu, _, _) = (
        runs["cuda"], runs["cpu"])
    lat_err = float((lat_g - lat_c).abs().max()) / max(1.0, float(lat_c.abs().max()))
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_errs, zero, zero_rows, _ = _grads_vs_cpu(torch, g_gpu, g_cpu)
    check(lat_err <= TRAIN_LOSS_RTOL,
          f"stacked: the extractor's latent differs by {lat_err} > {TRAIN_LOSS_RTOL}")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"stacked: the step's loss differs by {loss_rel} > {TRAIN_LOSS_RTOL}")
    check(max(grad_errs.values()) <= TRAIN_GRAD_RTOL,
          f"stacked: gradients differ: {grad_errs} > {TRAIN_GRAD_RTOL}")
    # (b) K1 once per forward (the top layer), the walk and dWh once per backward
    check(fwd_launch["gru_fwd"] == 1 and fwd_launch["gru_fwd_residuals"] == 0
          and fwd_launch["gru_bwd"] == 0,
          f"stacked: a no-grad forward launched {fwd_launch}")
    check(all(step_launch[k] == 1 for k in ("gru_fwd_residuals", "gru_bwd", "gru_dwh",
                                            "attention_fwd", "attention_bwd"))
          and step_launch["gru_fwd"] == 0, f"stacked: a training step launched {step_launch}")
    # (c) a warm L = 2 epoch against a warm L = 1 epoch on the same panel; the
    # counts of the L = 2 epoch are the phase's launches
    epochs, launches = {}, None
    for layers in (1, STACKED_LAYERS):
        tr = Trainer(cfg_of(layers), dataset, device="cuda")
        tr.fit()                                       # the first epoch pays set-up
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        _, out = tr.fit()
        torch.cuda.synchronize()
        rec = out["history"][0]
        check(np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
              and rec["skipped_steps"] == 0, f"stacked: the L = {layers} epoch {rec}")
        epochs[f"L{layers}"] = {"epoch_s_warm": rec["seconds"], "train_loss": rec["train_loss"],
                                "val_loss": rec["val_loss"], "steps": tr.steps_per_epoch}
        if layers == STACKED_LAYERS:
            launches = {c.__name__: c.launches for c in counters}
            steps = tr.steps_per_epoch
            val_batches = -(-len(tr.val_days) // tr.batch_days)
            check(launches["gru_fwd_residuals"] == launches["gru_bwd"] == launches["gru_dwh"]
                  == launches["attention_bwd"] == steps
                  and launches["gru_fwd"] == val_batches,
                  f"stacked: {steps} steps, {val_batches} validation batches, {launches}")
    work.cleanup()
    return {"phase": "stacked", "card": card,
            "config": f"flagship C158/T20/H64/K96/M128, gru_layers={STACKED_LAYERS}, f32, "
                      "days_per_step=1, 80 days x 300 stocks",
            "latent_max_rel_err": lat_err, "step_loss_rel_err": loss_rel,
            "grad_max_rel_err": max(grad_errs.values()),
            "grad_errors_top": dict(sorted(grad_errs.items(), key=lambda kv: -kv[1])[:5]),
            "zero_grad_params": zero, "zero_grad_rows": zero_rows,
            "limits": {"latent_and_loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL},
            "forward_launches": fwd_launch, "step_launches": step_launch,
            "epochs": epochs,
            "epoch_ratio_L2_over_L1": (epochs[f"L{STACKED_LAYERS}"]["epoch_s_warm"]
                                       / epochs["L1"]["epoch_s_warm"]),
            "launches": launches}


WF_SEED_DAYS = 120      # the store's first slab: 120 x 300 x 159 f32, 22.9 MB
WF_STOCKS = 300
WF_NEW_DAYS = 2
WF_CLIENTS = 4
WF_SAVE_EPOCHS = 3      # the save-time comparison's refits


def _wf_command(repo: str, m, run_dir: str, cycles: int, seed: int, chaos_json=None):
    """`python -m factorvae_tpu_torch.wf` at the widths of the ModelConfig
    `m` on the card, as a subprocess: a Popen whose stdout carries the cycle
    summaries."""
    import subprocess as sp

    env = {k: v for k, v in os.environ.items() if k != "FACTORVAE_CHAOS"}
    if chaos_json is not None:
        env["FACTORVAE_CHAOS"] = chaos_json
    argv = [sys.executable, "-m", "factorvae_tpu_torch.wf", "--run_dir", run_dir,
            "--cycles", str(cycles), "--force_refit", "--epochs", "1",
            "--init_days", str(WF_SEED_DAYS), "--new_days", str(WF_NEW_DAYS),
            "--stocks", str(WF_STOCKS), "--features", str(m.num_features),
            "--hidden", str(m.hidden_size), "--factors", str(m.num_factors),
            "--portfolios", str(m.num_portfolios), "--seq_len", str(m.seq_len),
            "--min_margin", "2",
            "--seed", str(seed)]
    return sp.Popen(argv, cwd=repo, env=env, stdout=sp.PIPE, stderr=sp.PIPE, text=True)


def _wf_wait(proc, what: str, want_rc: int = 0) -> list:
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == want_rc,
          f"wf (d): {what} exited {proc.returncode}, not {want_rc}: {err[-1500:]}")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def phase_wf(torch, seed: int, counters, card: str) -> dict:
    """The walk-forward refit at flagship width on the card (the module
    docstring's phase 16)."""
    import http.client
    import shutil
    import tempfile
    import threading

    from factorvae_tpu_torch.chaos import ChaosPlan, Fault
    from factorvae_tpu_torch.chaos import ops as chaos_ops
    from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from factorvae_tpu_torch.data.append import PanelStore
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import continuation_panel, synthetic_panel_dense
    from factorvae_tpu_torch.ops.kernels import plain
    from factorvae_tpu_torch.ops.kernels.attention import attention_fwd_plain
    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd_plain
    from factorvae_tpu_torch.params import read_state_dict
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon, TickScheduler, serve_http
    from factorvae_tpu_torch.serve.registry import ModelRegistry, RegistryError
    from factorvae_tpu_torch.train.checkpoint import Checkpointer
    from factorvae_tpu_torch.train.trainer import Trainer
    from factorvae_tpu_torch.wf.operator import WalkForwardOperator, warm_refit

    repo = os.path.dirname(os.path.abspath(__file__))
    m = get_preset("flagship").model
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_wf_")
    # (a) in process, the command's rig: a store of 120 days, a stream-resident
    # dataset, the daemon behind serve_http --scheduler with 4 clients
    store = PanelStore.create(os.path.join(work.name, "store"),
                              synthetic_panel_dense(WF_SEED_DAYS, WF_STOCKS, m.num_features,
                                                    seed=seed))
    dataset = PanelDataset(store.load_panel(), seq_len=m.seq_len, device="cuda",
                           residency="stream")
    # the command's Config (wf/__main__.py) at these widths
    cfg = Config(
        model=ModelConfig(num_features=m.num_features, hidden_size=m.hidden_size,
                          num_factors=m.num_factors, num_portfolios=m.num_portfolios,
                          seq_len=m.seq_len, stochastic_inference=False),
        data=DataConfig(seq_len=m.seq_len, start_time=None, fit_end_time=None,
                        val_start_time=None, val_end_time=None, panel_residency="stream"),
        train=TrainConfig(seed=seed, run_name="walkforward", num_epochs=1))
    daemon = ScoringDaemon(ModelRegistry(device="cuda"), dataset, stochastic=False,
                           seed=seed, drift_threshold=0.5)
    op = WalkForwardOperator(store, dataset, daemon, cfg, os.path.join(work.name, "run"),
                             refit_epochs=1, force_refit=True, min_margin=2.0,
                             drift_threshold=0.5, device="cuda")
    t0 = time.perf_counter()
    op.ensure_incumbent(epochs=1)
    torch.cuda.synchronize()
    bootstrap_s = time.perf_counter() - t0
    cand_cfg = op._candidate_config("probe")
    warm0 = op._warm_params(Trainer(cand_cfg, dataset, device="cuda").init_state())
    probe_day = int(dataset.split_days(None, None)[-1])
    sched = TickScheduler(daemon, tick_ms=2.0)
    port, srv_thread = _start_front(serve_http, daemon, sched)
    stop, answers = threading.Event(), []

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        while not stop.is_set():
            status, body = _http(conn, "POST", "/score",
                                 {"id": c, "model": "prod", "day": probe_day})
            answers.append((status, json.loads(body)))
        conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(WF_CLIENTS)]
    for th in threads:
        th.start()
    # each judge-stage launch of K1 and K4 keeps its inputs, for the plain check
    seen, tag = [], {"rung": None}
    real_judge = op._stage_judge

    def judge(incoming):
        tag["rung"] = "judge"
        try:
            return real_judge(incoming)
        finally:
            tag["rung"] = None

    op._stage_judge = judge
    real = _recording(seen, tag)
    piece = continuation_panel(store.instruments, store.end_date, WF_NEW_DAYS,
                               m.num_features, seed=seed * 100003 + 2)
    try:
        time.sleep(0.2)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        summary = op.run_cycle(piece)
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
    finally:
        _restore(real)
        op._stage_judge = real_judge
        time.sleep(0.2)
        stop.set()
        for th in threads:
            th.join(60)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        _http(conn, "POST", "/score", {"cmd": "shutdown"})
        conn.close()
        srv_thread.join(60)
    check(summary["triggered"] and summary["promoted"] and all(summary["ran"].values()),
          f"wf (a): the cycle {summary['ran']} promoted={summary['promoted']}")
    check(answers and all(st == 200 and resp.get("ok") for st, resp in answers),
          f"wf (a): {sum(1 for st, r in answers if st != 200 or not r.get('ok'))} of "
          f"{len(answers)} requests failed during the cycle")
    promoted = summary["stages"]["promote"]["model"]
    flips = [resp["model"] for _, resp in answers]
    check(flips[-1] == promoted, "wf (a): the clients never saw the promoted model")
    for name, count in launches.items():
        check(count > 0, f"wf (a): {name} was not launched in the cycle: {launches}")
    plain_fn = {"gru_fwd": gru_fwd_plain, "attention_fwd": attention_fwd_plain}
    judge_errs = {}
    with torch.inference_mode():
        for name in plain_fn:
            hit = next(((args, out) for rung, n, args, out in seen
                        if rung == "judge" and n == name), None)
            check(hit is not None, f"wf (a): no {name} launch in the judge stage")
            args, out = hit
            ref = plain(plain_fn[name], args[0].ndim == 4, *args)
            judge_errs[name] = {"max_abs_err": float((out - ref).abs().max()),
                                "shape": list(args[0].shape)}
    del seen
    check(judge_errs["gru_fwd"]["max_abs_err"] <= K1_TOL
          and judge_errs["attention_fwd"]["max_abs_err"] <= K4_TOL,
          f"wf (a): the judge's launches vs their plain versions {judge_errs}")
    # the cycle's refit is bitwise a plain warm_refit from the same warm weights
    refit = summary["stages"]["refit"]
    plain_cfg = op._candidate_config(summary["cycle"])
    plain_cfg = dataclasses.replace(plain_cfg, train=dataclasses.replace(
        plain_cfg.train, save_dir=os.path.join(work.name, "plain")))
    state, info, _ = warm_refit(plain_cfg, dataset, warm_params=warm0, device="cuda")
    cycle_sd = read_state_dict(refit["warm"]["path"])
    plain_sd = {k: v.cpu() for k, v in state.model.state_dict().items()}
    check(all(torch.equal(cycle_sd[k], plain_sd[k]) for k in plain_sd)
          and info["best_val"] == refit["warm"]["best_val"],
          "wf (a): the cycle's refit is not bitwise a plain warm_refit")

    # (b) the refit's time blocked in save(): async against sync saves, and
    # the sha256 pass per manifest
    saves = {}
    for mode in (True, False):
        c = dataclasses.replace(plain_cfg, train=dataclasses.replace(
            plain_cfg.train, num_epochs=WF_SAVE_EPOCHS, async_checkpointing=mode,
            save_dir=os.path.join(work.name, f"save_{mode}")))
        tr = Trainer(c, dataset, device="cuda")
        st = tr.init_state()
        st.model.load_state_dict(warm0)
        tr.fit(state=st)
        ck = tr.last_checkpointer
        check(ck.all_steps() == list(range(WF_SAVE_EPOCHS))
              and all(ck.verify_step(s) == (True, None) for s in ck.all_steps()),
              f"wf (b): the {'async' if mode else 'sync'} refit's checkpoints")
        saves["async" if mode else "sync"] = {
            "save_blocked_s": ck.save_seconds, "manifest_sha256_s": ck.manifest_seconds,
            "payload_bytes": os.path.getsize(ck._path(0)), "dir": ck.directory}
    check(saves["async"]["payload_bytes"] == saves["sync"]["payload_bytes"],
          "wf (b): async and sync payloads differ in size")

    # (c) corrupt_checkpoint on the newest epoch: restore falls back and
    # quarantines; corrupt_artifact: register_checkpoint refuses
    ck = Checkpointer(saves["async"].pop("dir"))
    saves["sync"].pop("dir")
    newest = ck.latest_step()
    chaos_ops.corrupt_checkpoint_step(ck.directory, newest, rng_seed=seed)
    template = Trainer(plain_cfg, dataset, device="cuda").init_state()
    meta = ck.restore(template)
    quarantined = ck.quarantined_steps()
    check(meta["epoch"] == newest - 1 and quarantined == [newest],
          f"wf (c): restore gave epoch {meta['epoch']}, quarantined {quarantined}")
    bad = os.path.join(work.name, "corrupt_weights")
    shutil.copytree(refit["warm"]["path"], bad)
    shutil.copy(refit["warm"]["path"] + ".manifest.json", bad + ".manifest.json")
    chaos_ops.corrupt_file(os.path.join(bad, "weights.pt"), rng_seed=seed)
    try:
        ModelRegistry(device="cuda").register_checkpoint(bad)
        refused = None
    except RegistryError as e:
        refused = str(e)
    check(refused is not None and "failed manifest verification" in refused,
          f"wf (c): the registry admitted corrupted weights ({refused})")

    # (d) the command as a subprocess: a clean cycle, kill_mid_refit in the
    # second, the re-run resuming it; against the never-killed run
    # (bootstrap and two cycles), which runs beside the clean cycle
    ref_dir, kill_dir = (os.path.join(work.name, d) for d in ("ref", "killed"))
    t_d = time.perf_counter()
    ref_proc = _wf_command(repo, m, ref_dir, 2, seed)
    clean_proc = _wf_command(repo, m, kill_dir, 1, seed)
    _wf_wait(clean_proc, "the clean cycle")
    ref = _wf_wait(ref_proc, "the reference run")
    t0 = time.perf_counter()
    _wf_wait(_wf_command(repo, m, kill_dir, 1, seed, ChaosPlan(
        [Fault("kill_mid_refit", step=1)]).to_json()), "the killed cycle", want_rc=-9)
    killed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = _wf_wait(_wf_command(repo, m, kill_dir, 1, seed), "the resume")[-1]
    resume_s = time.perf_counter() - t0
    check(resumed["cycle"] == ref[-1]["cycle"] == "c00003" and resumed["promoted"]
          and resumed["ran"]["append"] is False and resumed["ran"]["refit"] is True,
          f"wf (d): the resumed cycle {resumed['cycle']} ran {resumed['ran']}")
    slabs = [s["sha256"] for s in PanelStore(os.path.join(kill_dir, "store")).slabs]
    ref_slabs = [s["sha256"] for s in PanelStore(os.path.join(ref_dir, "store")).slabs]
    with open(os.path.join(resumed["stages"]["refit"]["warm"]["path"], "weights.pt"),
              "rb") as a, open(os.path.join(ref[-1]["stages"]["refit"]["warm"]["path"],
                                            "weights.pt"), "rb") as b:
        same_weights = a.read() == b.read()
    check(slabs == ref_slabs and same_weights,
          f"wf (d): slabs equal {slabs == ref_slabs}, weights equal {same_weights}")
    command_s = time.perf_counter() - t_d
    work.cleanup()
    return {"phase": "wf", "card": card,
            "config": "flagship C158/T20/H64/K96/M128, f32, 300 stocks, a seed store of "
                      f"{WF_SEED_DAYS} days, {WF_NEW_DAYS} new days a cycle, stream "
                      "residency, 1 bootstrap and 1 refit epoch, force_refit, min_margin 2",
            "panel_mb": WF_SEED_DAYS * WF_STOCKS * (m.num_features + 1) * 4 / 1e6,
            "bootstrap_s": bootstrap_s, "cycle_s": cycle_s,
            "stage_s": summary["walls"], "refit_to_serve_s": summary.get("refit_to_serve_s"),
            "requests": len(answers), "failed_requests": 0, "clients": WF_CLIENTS,
            "launches": launches, "judge_kernel_vs_plain": judge_errs,
            "tolerance": {"gru_fwd": K1_TOL, "attention_fwd": K4_TOL},
            "refit_bitwise_plain_warm_refit": True,
            "saves": saves,
            "corrupt_checkpoint": {"quarantined": quarantined,
                                   "restored_epoch": meta["epoch"]},
            "corrupt_artifact_refused": refused.split(" — ")[0],
            "subprocess": {"killed_rc": -9, "killed_s": killed_s, "resume_s": resume_s,
                       "resumed_stage_s": resumed["walls"], "ran": resumed["ran"],
                       "weights_bytes_equal": same_weights, "slabs_equal": True,
                       "phase_d_wall_s": command_s}}


# Limits of the obs phase. One deterministic step with the probes, card
# against CPU from the same weights: the gradient norm at the train phase's
# gradient limit (TRAIN_GRAD_RTOL), the factor moments at TRAIN_LOSS_RTOL,
# the update and the parameter norm at 1e-3 and 1e-4: a first Adam step
# moves each element by about +-lr whatever its gradient's size, so the
# parameters whose gradient is zero up to rounding (ZERO_GRAD_ATOL: the
# portfolio bias, key-bias rows) step in directions that differ between
# the devices, by up to 2 lr an element (the parameter norm read up to
# 1.9e-5 apart, relative, on an H100); the non-finite counts equal. A fleet
# lane against its seed's solo run on the card: the fleet phase's loss
# limit 1e-5 for the losses, and the probes at the step's limits above
# (the update norm at 5e-3: the zero-gradient parameters' noise steps add
# up over an epoch, as on the CPU, tests/test_torch_probes.py).
OBS_STEP_RTOL = {"grad_norm": TRAIN_GRAD_RTOL, "param_norm": 1e-4,
                 "update_norm": 1e-3, "mu_spread_sum": TRAIN_LOSS_RTOL,
                 "sigma_mean_sum": TRAIN_LOSS_RTOL}
OBS_LANE_RTOL = {"grad_norm_max": TRAIN_GRAD_RTOL, "grad_norm_mean": TRAIN_GRAD_RTOL,
                 "update_norm_mean": 5e-3, "param_norm_last": TRAIN_LOSS_RTOL,
                 "factor_mu_spread": TRAIN_LOSS_RTOL, "factor_sigma_mean": TRAIN_LOSS_RTOL}
OBS_REPS = 3           # ABAB pairs of warm epochs, probes off and on
# A kernel wrapper's launch in a Kineto trace: the CUDA functions one launch
# runs; the first one runs once per launch (the count held against the
# wrapper's launch counter), the device time per launch sums them all.
KERNEL_FUNCTIONS = {
    "gru_fwd_residuals": (r"gru_fwd(?:_kernel<[^,>]+|_wide_kernel<[^>]*),\s*true",),
    "gru_fwd": (r"gru_fwd(?:_kernel<[^,>]+|_wide_kernel<[^>]*),\s*false",),
    "gru_bwd": (r"gru_walk(?:_wide)?_kernel",),
    "gru_dwh": (r"gru_dwh(?:_wide)?_kernel", r"gru_dwh_reduce_kernel"),
    "attention_fwd": (r"attention_fwd(?:_wide)?_kernel", r"attention_fwd_prep_kernel",
                      r"attention_fwd_ctx_kernel"),
    "attention_bwd": (r"attention_bwd_head(?:_wide)?_kernel", r"attention_bwd_prep_kernel",
                      r"attention_bwd_weights_kernel", r"attention_bwd_latent(?:_wide)?_kernel"),
}


def _scalar_rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def _kernel_rows(by_name) -> dict:
    """{wrapper: {"count", "device_us", "us_per_launch", "functions"}} of a
    trace summary's (name, us, count) rows."""
    out = {}
    for wrapper, patterns in KERNEL_FUNCTIONS.items():
        first = [(n, us, c) for n, us, c in by_name if re.search(patterns[0], n)]
        every = [(n, us, c) for n, us, c in by_name
                 if any(re.search(p, n) for p in patterns)]
        count = sum(c for _, _, c in first)
        us = sum(u for _, u, _ in every)
        out[wrapper] = {"count": count, "device_us": us,
                        "us_per_launch": us / count if count else None,
                        "functions": sorted({n.split("::")[-1].split("(")[0]
                                             for n, _, _ in every})}
    return out


def _within(r: dict, calls) -> list:
    """The calls that start in trace event r's span, in time order."""
    return sorted((c for c in calls if r["ts"] <= c["ts"] <= r["ts"] + r["dur"]),
                  key=lambda c: c["ts"])


def _launch_accounting(log_dir: str, counted: dict, before: dict = None) -> dict:
    """How a capture saw each wrapper's launches. `counted` maps a wrapper to
    its launch counter's rise over the counted part of the capture, `before`
    to its launches earlier in the same capture (a warm-up). Per wrapper:
    `ranges`, its `launch_range`s on the host (the profiler's own host
    events are not lost), each holding the launch calls of its own thread
    in its span, or of any thread where its own has none; `kernels`, the records of its first CUDA function
    (`KERNEL_FUNCTIONS`) launched at or after the start of its first
    counted range; `lost`, the counted ranges whose first launch call has no
    kernel record (by correlation id). A record is placed on the host's
    clock by its launch call (same correlation id), and by its own start
    only where the capture holds no such call: a kernel record's start is
    the device's clock converted to the host's, which can lead its launch
    call (on an H100 the first gru_dwh kernel of an epoch's capture started
    before its own range once), and can trail the next range's start.
    `kernel_before_launch` counts the records that start before their
    launch call, `min_launch_to_kernel_us` is the least gap. `lost_total`
    counts every launch call of the capture without a kernel record. CUPTI
    drops records in some captures (0 to 56 of ~25,500 in a flagship
    epoch's on an H100), and those of the first launches after a capture
    starts (the daemon's capture starts with a warm-up request)."""
    from factorvae_tpu_torch.utils.trace_summary import _load_events, find_trace_files

    before = before or {}
    events = [e for f in find_trace_files(log_dir) for e in _load_events(f)
              if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    recorded = {(e.get("args") or {}).get("correlation") for e in kernels}
    by_corr: dict = {}
    for e in kernels:
        by_corr.setdefault((e.get("args") or {}).get("correlation"), []).append(e["name"])
    t0 = min((e["ts"] for e in events), default=0.0)
    window = max((e["ts"] + e.get("dur", 0) for e in events), default=0.0) - t0
    calls: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "aunch" in e.get("name", ""):
            calls.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    every = [c for cs in calls.values() for c in cs]
    launched_at = {(c.get("args") or {}).get("correlation"): c["ts"] for c in every}
    gaps = [e["ts"] - launched_at[c] for e in kernels
            for c in [(e.get("args") or {}).get("correlation")] if c in launched_at]
    out = {"lost_total": sum((c.get("args") or {}).get("correlation") not in recorded
                             for c in every),
           "launch_calls": len(every), "kernel_records": len(recorded),
           "kernel_before_launch": sum(g < 0 for g in gaps),
           "min_launch_to_kernel_us": min(gaps, default=None)}
    for name, want in counted.items():
        ranges = sorted((e for e in events
                         if e.get("cat") == "user_annotation" and e["name"] == name),
                        key=lambda e: e["ts"])
        mine = ranges[before.get(name, 0):]
        since = mine[0]["ts"] if mine else float("inf")
        lost = 0
        unrecorded = []
        for r in mine:
            # a capture started on another thread (the daemon's) books the
            # launch calls under another thread id than the ranges
            inside = (_within(r, calls.get((r.get("pid"), r.get("tid")), ()))
                      or _within(r, every))
            corrs = [(c.get("args") or {}).get("correlation") for c in inside]
            lost += bool(inside) and corrs[0] not in recorded
            if not any(re.search(KERNEL_FUNCTIONS[name][0], k)
                       for c in corrs for k in by_corr.get(c, ())):
                unrecorded.append({
                    "kernel": re.match(r"\w+", KERNEL_FUNCTIONS[name][0]).group(),
                    "tid": r.get("tid"),
                    "launch_us": (inside[0]["ts"] if inside else r["ts"]) - t0,
                    "window_us": [0.0, window], "launch_calls": len(inside),
                    "correlations": corrs})
        out[name] = {"ranges": len(ranges), "counted_ranges": len(mine), "lost": int(lost),
                     "kernels": sum(1 for e in kernels if launched_at.get(
                         (e.get("args") or {}).get("correlation"), e["ts"]) >= since
                         and re.search(KERNEL_FUNCTIONS[name][0], e["name"])),
                     "unrecorded": unrecorded}
    return out


def _check_counts(what: str, acct: dict, counted: dict, before: dict = None) -> None:
    """Each wrapper's host ranges equal its launches in the capture, and its
    kernels after its first counted range, plus the records CUPTI lost in
    those ranges, equal its launch counter's rise. The capture's other lost
    records (`lost_total`: 0 to 56 of ~25,500 in an epoch's, up to 58 of
    512 in the daemon's on an H100) are reported, not held."""
    before = before or {}
    for name, want in counted.items():
        a = acct[name]
        ok = (want > 0 and a["ranges"] == want + before.get(name, 0)
              and a["kernels"] + a["lost"] == want)
        if not ok:      # name each counted launch the capture holds no record of
            for u in a.get("unrecorded", ()):
                print(f"chip_smoke: {what}: {name} launch without a kernel record: "
                      f"{json.dumps(u)}", file=sys.stderr, flush=True)
        check(ok, f"{what}: {name} kernels {a['kernels']} + lost {a['lost']}, host ranges "
                  f"{a['ranges']} (before {before.get(name, 0)}) vs its launch counter "
                  f"{want}; launches without a record (kernel, thread, launch time in "
                  f"the capture window, us): "
                  f"{[(u['kernel'], u['tid'], round(u['launch_us'], 1), round(u['window_us'][1], 1)) for u in a.get('unrecorded', ())][:8]}; "
                  f"records that start before their launch call: "
                  f"{acct.get('kernel_before_launch')}")


def _obs_logger(path, on_event):
    """A MetricsLogger on `path` that calls on_event(event, fields) after
    each record."""
    from factorvae_tpu_torch.utils.logging import MetricsLogger

    class Hooked(MetricsLogger):
        def log(self, event, _echo=None, **fields):
            super().log(event, _echo, **fields)
            on_event(event, fields)

    return Hooked(jsonl_path=path, echo=False)


def _probe_step(torch, trainer_cls, cfg, ds, weights) -> dict:
    """One deterministic train step with the probes from `weights`: its
    probe aux as floats."""
    from factorvae_tpu_torch.train.loop import train_step

    tr = trainer_cls(cfg, ds, device=str(ds.device))
    st = tr.init_state()
    st.model.load_state_dict(weights)
    aux = train_step(st, ds, tr._order(tr.train_days, True, 0)[0], guard=True, probes=True)
    return {k: float(v) for k, v in aux.items()}


def _ledger_check(root: str, card: str, windows: int, epoch_s: list) -> dict:
    """obs (e): two rows made on the card (train windows/s of two warm
    epochs) with a CPU-rig row between them in a temp history; the report
    must compare the card's rows and skip the CPU's, and the card's rows
    must name the card and its power limit."""
    import torch

    from factorvae_tpu_torch.obs import ledger

    path = os.path.join(root, "bench_history.jsonl")
    metric = "obs_epoch_train_windows_per_s"
    rig = ledger.this_rig()
    cpu_rig = {**rig, "platform": "cpu", "device": None, "device_count": 0}
    cpu_rig.pop("power_limit", None)
    for k, run_meta in ((0, None), (None, cpu_rig), (1, None)):
        value = windows / epoch_s[k] if k is not None else 1.0
        check(ledger.append_row({"metric": metric, "value": value, "unit": "windows/s",
                                 "platform": "cuda" if run_meta is None else "cpu"},
                                path=path, run_meta=run_meta) == path,
              "obs (e): a ledger row was not written")
    rows = ledger.load_history(path)
    ok, report = ledger.check(path)
    (entry,) = report["metrics"]
    card_rows = [r["run_meta"] for r in rows if r["platform"] == "cuda"]
    power = card.rsplit(",", 1)[-1].strip()
    check(len(rows) == 3 and entry["history"] == 2 and entry["other_rig_skipped"] == 1
          and entry.get("trailing_median") == round(windows / epoch_s[0], 3)
          and entry["status"] != "no_comparable_history",
          f"obs (e): the ledger's report {report}")
    check(all(m["device"] == torch.cuda.get_device_name(0) and m["power_limit"] == power
              for m in card_rows),
          f"obs (e): the card's rows name {[(m['device'], m['power_limit']) for m in card_rows]}"
          f", not {card}")
    return {"ok": ok, "entry": entry, "rig": {"device": card_rows[0]["device"],
                                             "power_limit": card_rows[0]["power_limit"]},
            "report": ledger.format_report(report).splitlines()}


def phase_obs(torch, seed: int, counters, card: str) -> dict:
    """The run observatory at flagship width on the 80-day panel (see the
    module docstring, phase 18)."""
    import http.client
    import tempfile

    from factorvae_tpu_torch import chaos, cli
    from factorvae_tpu_torch.chaos import ChaosPlan, Fault
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import panel_to_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.obs import report, timeline
    from factorvae_tpu_torch.obs.metrics import TextfileExporter
    from factorvae_tpu_torch.obs.probes import TRAIN_PROBE_KEYS
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon, TickScheduler, serve_http
    from factorvae_tpu_torch.serve.registry import ModelRegistry
    from factorvae_tpu_torch.train.fleet import FleetTrainer
    from factorvae_tpu_torch.train.loop import train_epoch
    from factorvae_tpu_torch.train.trainer import Trainer
    from factorvae_tpu_torch.utils.logging import Timeline, install_timeline
    from factorvae_tpu_torch.utils.profiling import PROFILE_REQUEST_BASENAME
    from factorvae_tpu_torch.utils.trace_summary import summarize_trace

    t_phase = time.perf_counter()
    base = get_preset("flagship")
    m = base.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    root = work.name

    def cfg_of(save, probes=True, **train):
        return dataclasses.replace(
            base,
            data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                     val_start_time=dates[50], val_end_time=dates[69]),
            train=dataclasses.replace(base.train, **{
                **dict(seed=seed, num_epochs=1, days_per_step=1, checkpoint_every=0,
                       obs_probes=probes, save_dir=os.path.join(root, save)), **train}))

    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    by_name = {c.__name__: c for c in counters}

    # (a) probes. One deterministic step, card against CPU, same weights.
    det = cfg_of("det")
    det = dataclasses.replace(det, model=dataclasses.replace(m, dropout_rate=0.0,
                                                             recon_loss="nll"))
    weights = {k: v.cpu() for k, v in
               Trainer(det, dataset, device="cuda").init_state().model.state_dict().items()}
    step = {dev: _probe_step(torch, Trainer, det,
                             dataset if dev == "cuda" else
                             PanelDataset(panel, seq_len=m.seq_len, device="cpu"), weights)
            for dev in ("cuda", "cpu")}
    step_err = {k: abs(step["cuda"][k] - step["cpu"][k]) / abs(step["cpu"][k])
                for k in OBS_STEP_RTOL}
    for k, lim in OBS_STEP_RTOL.items():
        check(step_err[k] <= lim, f"obs (a): step probe {k} card {step['cuda'][k]} vs CPU "
                                  f"{step['cpu'][k]} ({step_err[k]} > {lim})")
    for k in ("nonfinite_grads", "nf_loss"):
        check(step["cuda"][k] == step["cpu"][k] == 0.0, f"obs (a): step {k} {step}")

    # warm epochs, probes off and on, ABAB from the same init: bitwise, and
    # the probes' cost
    Trainer(cfg_of("warm", probes=False), dataset, device="cuda").fit()
    walls, fits = {"off": [], "on": []}, {}
    for rep in range(OBS_REPS):
        for mode in ("off", "on"):
            tr = Trainer(cfg_of(f"ab_{mode}_{rep}", probes=mode == "on"), dataset,
                         device="cuda")
            torch.cuda.synchronize()
            state, out = tr.fit()
            torch.cuda.synchronize()
            walls[mode].append(out["history"][0]["seconds"])
            if rep == 0:
                fits[mode] = (state, out["history"][0])
    (s_off, r_off), (s_on, r_on) = fits["off"], fits["on"]
    sd_off, sd_on = s_off.model.state_dict(), s_on.model.state_dict()
    bitwise_weights = all(torch.equal(sd_off[k], sd_on[k]) for k in sd_off)
    loss_keys = ("train_loss", "train_recon", "train_kl", "val_loss", "val_recon", "val_kl")
    bitwise_losses = all(r_off[k] == r_on[k] for k in loss_keys)
    check(bitwise_weights and bitwise_losses,
          "obs (a): probes on changed the weights or the losses of the epoch")
    check(all(np.isfinite(r_on[k]) for k in TRAIN_PROBE_KEYS),
          f"obs (a): probes {dict((k, r_on[k]) for k in TRAIN_PROBE_KEYS)}")
    med = {k: float(np.median(v)) for k, v in walls.items()}
    cost = {"epoch_s": walls, "median_s": med,
            "probe_cost_frac": med["on"] / med["off"] - 1.0,
            "probe_cost_ms_per_step": (med["on"] - med["off"]) * 1e3 / 50,
            "order": "off, on x3 (ABAB)", "steps": 50}
    print(f"[obs] (a) step and cost done at {time.perf_counter() - t_phase:.1f}s",
          file=sys.stderr)

    # a nan_grads epoch: the probes see it, the report flags it, the
    # rollback answers it
    nan_path = os.path.join(root, "nan.jsonl")
    nan_logger = _obs_logger(nan_path, lambda e, f: None)
    prev_tl = install_timeline(Timeline(nan_logger))
    try:
        with chaos.active(ChaosPlan([Fault("nan_grads", epoch=1)])):
            _, nan_out = Trainer(cfg_of("nan", num_epochs=3, days_per_step=5,
                                        checkpoint_every=1, recover_after=1),
                                 dataset, device="cuda", logger=nan_logger).fit()
    finally:
        install_timeline(prev_tl)
        nan_logger.finish()
    poisoned = nan_out["history"][1]
    nan_run, _ = timeline.open_run(nan_path)
    nan_flags = sorted({(f["flag"], f["epoch"]) for f in report.build_report(nan_run)["flags"]},
                       key=str)
    rollbacks = [r for r in nan_run["events"] if r.get("event") == "recovery"]
    check(poisoned["nonfinite_grads"] > 0 and np.isnan(poisoned["update_norm_mean"]),
          f"obs (a): the nan_grads epoch's probes {poisoned}")
    check(("nonfinite", 1) in nan_flags, f"obs (a): the report's flags {nan_flags}")
    check([(r["kind"], r["epoch"]) for r in rollbacks][:1] == [("rollback", 1)],
          f"obs (a): the recovery trail {rollbacks}")
    nan_grads = {"epochs": [r["epoch"] for r in nan_out["history"]],
                 "nonfinite_grads": poisoned["nonfinite_grads"],
                 "update_norm_mean": poisoned["update_norm_mean"],
                 "skipped_steps": poisoned["skipped_steps"], "report_flags": nan_flags,
                 "recovery": [(r["kind"], r["epoch"], r.get("restored_step"))
                              for r in rollbacks]}

    # a seed fleet of four with probes against each seed's solo run
    seeds = [seed + i for i in range(4)]
    fcfg = cfg_of("fleet")
    _, fout = FleetTrainer(fcfg, dataset, seeds=seeds, device="cuda").fit()
    frec = fout["history"][0]
    lane_err = {k: 0.0 for k in OBS_LANE_RTOL}
    loss_err = 0.0
    for i, s in enumerate(seeds):
        solo_cfg = dataclasses.replace(fcfg, train=dataclasses.replace(fcfg.train, seed=s))
        _, solo = Trainer(solo_cfg, dataset, device="cuda").fit()
        srec = solo["history"][0]
        loss_err = max(loss_err, _scalar_rel(frec["train_loss"][i], srec["train_loss"]))
        for k in OBS_LANE_RTOL:
            lane_err[k] = max(lane_err[k], _scalar_rel(frec[k][i], srec[k]))
        check(frec["nonfinite_grads"][i] == srec["nonfinite_grads"] == 0,
              f"obs (a): lane {i} non-finite gradients")
    check(all(np.isfinite(frec[k]).all() for k in TRAIN_PROBE_KEYS),
          f"obs (a): the fleet's probes {dict((k, frec[k]) for k in TRAIN_PROBE_KEYS)}")
    check(loss_err <= 1e-5, f"obs (a): a fleet lane's loss vs its solo run {loss_err}")
    for k, lim in OBS_LANE_RTOL.items():
        check(lane_err[k] <= lim, f"obs (a): a fleet lane's {k} vs its solo run "
                                  f"{lane_err[k]} > {lim}")
    probes = {"step": {"cuda": step["cuda"], "cpu": step["cpu"], "rel_err": step_err,
                       "limits": OBS_STEP_RTOL},
              "bitwise_off_on": {"weights": bitwise_weights, "losses": bitwise_losses},
              "epoch_probes": {k: r_on[k] for k in TRAIN_PROBE_KEYS},
              "cost": cost, "nan_grads": nan_grads,
              "fleet": {"seeds": seeds, "lane_vs_solo_rel_err": lane_err,
                        "loss_rel_err": loss_err, "limits": OBS_LANE_RTOL,
                        "probes": {k: frec[k] for k in TRAIN_PROBE_KEYS}}}
    print(f"[obs] (a) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)
    ledger_out = _ledger_check(root, card, int(panel.valid[:50].sum()), walls["off"][:2])

    # (b) the trainer's on-demand capture: a PROFILE_REQUEST before epoch 1
    # of a run with a metrics stream. The counters go to 0 when epoch 0's
    # record is written, just before epoch 1; they are read at the capture's
    # record (its train epoch) and at epoch 1's record (the whole epoch).
    marks = {}

    def on_event(event, fields):
        if event == "epoch" and fields["epoch"] == 0:
            with open(os.path.join(root, "prof", PROFILE_REQUEST_BASENAME), "w") as fh:
                fh.write("")
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
        elif event == "profile_capture":
            marks["train"] = {c.__name__: c.launches for c in counters}
        elif event == "epoch" and fields["epoch"] == 1:
            torch.cuda.synchronize()
            marks["epoch"] = {c.__name__: c.launches for c in counters}

    os.makedirs(os.path.join(root, "prof"))
    prof_path = os.path.join(root, "prof", "run.jsonl")
    prof_logger = _obs_logger(prof_path, on_event)
    prev_tl = install_timeline(Timeline(prof_logger))
    try:
        ptr = Trainer(cfg_of("prof_models", num_epochs=2), dataset, device="cuda",
                      logger=prof_logger)
        pstate, pout = ptr.fit()
    finally:
        install_timeline(prev_tl)
        prof_logger.finish()
    prun, _ = timeline.open_run(prof_path)
    (cap,) = [r for r in prun["events"] if r.get("event") == "profile_capture"]
    check("error" not in cap and cap.get("files", 0) >= 1 and cap.get("total_us", 0) > 0,
          f"obs (b): the profile_capture record {cap}")
    launches = marks["epoch"]
    for name, n in launches.items():
        check(n > 0, f"obs (b): {name} was not launched in the profiled epoch {launches}")
    summary = summarize_trace(cap["dir"], top=100000)
    krows = _kernel_rows(summary["by_name"])
    trained = ("gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_fwd", "attention_bwd")
    acct = _launch_accounting(cap["dir"], {n: marks["train"][n] for n in trained})
    _check_counts("obs (b)", acct, {n: marks["train"][n] for n in trained})
    (span,) = [s for s in prun["spans"] if s["name"] == "train_epoch_1"]
    steps = ptr.steps_per_epoch
    busy = {"capture_device_ms": cap["total_us"] / 1e3, "train_epoch_span_ms": span["dur"] * 1e3,
            "busy_share": cap["total_us"] / 1e6 / span["dur"]}
    # `_busy_share` over 5 probed steps, as the fleet phase reads it
    bchunks = [(d, o[:5]) for d, o in ptr._chunks(ptr.train_days, True, 2)][:1]
    busy["_busy_share_5_steps"] = _busy_share(
        torch, lambda: train_epoch(pstate, bchunks, guard=True, probes=True))
    profiler = {"record": {k: cap[k] for k in ("epoch", "files", "total_us", "host_us", "top")},
                "launches_train_epoch": marks["train"], "launches": launches,
                "kernels": krows, "accounting": acct, "busy": busy, "steps": steps,
                "host_rows": summary["host_by_name"][:12],
                "transfer": summary["transfer"]}
    print(f"[obs] (b) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)

    # (c) the CLI: --obs --prom_textfile --profile on a stream-resident
    # panel (a stream lane) with checkpoints (a checkpoint lane), then
    # --debug_nans
    pkl = os.path.join(root, "panel.pkl")
    panel_to_frame(panel).to_pickle(pkl)
    out = os.path.join(root, "cli")
    cli_argv = ["--preset", "flagship", "--dataset", pkl, "--seed", str(seed),
                "--run_name", "obs", "--start_time", dates[0], "--fit_end_time", dates[49],
                "--val_start_time", dates[50], "--val_end_time", dates[69],
                "--score_start", dates[70], "--score_end", dates[79],
                "--deterministic_scores", "--num_epochs", "2",
                "--panel_residency", "stream", "--stream_chunk_days", "16",
                "--save_dir", f"{out}/models", "--score_dir", f"{out}/scores",
                "--metrics_jsonl", f"{out}/RUN.jsonl"]
    prom, trace_dir = f"{out}/x.prom", f"{out}/trace"
    drive = _cli_drive(torch, cli, counters, cli_argv + ["--obs", "--prom_textfile", prom,
                                                         "--profile", trace_dir])
    epochs = _of(drive, "epoch")
    prom_text = open(prom).read()
    again = TextfileExporter(f"{out}/again.prom")
    for rec in epochs:
        again.export_epoch({k: v for k, v in rec.items() if k not in ("ts", "event")})
    check(len(epochs) == 2 and "factorvae_train_epoch 1\n" in prom_text
          and prom_text == open(f"{out}/again.prom").read(),
          "obs (c): the .prom file is not the last epoch's")
    proc = subprocess.run([sys.executable, "-m", "factorvae_tpu_torch.utils.trace_summary",
                           trace_dir, "--top", "40"], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0 and "gru_walk_kernel" in proc.stdout
          and "attention_fwd_kernel" in proc.stdout,
          f"obs (c): trace_summary exited {proc.returncode}: {proc.stdout[-800:]}"
          f"{proc.stderr[-800:]}")
    crun, cwarn = timeline.open_run(f"{out}/RUN.jsonl")
    cflags = report.build_report(crun)["flags"]
    check(cflags == [] and cwarn == [], f"obs (c): the clean run's report flags {cflags}")
    overlap = timeline.overlap_report(timeline.span_sections(crun)[-1])
    lanes = {r["resource"]: r["overlap_frac"] for r in overlap}
    check({"device", "stream", "checkpoint"} <= set(lanes),
          f"obs (c): timeline lanes {sorted(lanes)}")
    nans = _cli_drive(torch, cli, counters,
                      cli_argv[:-1] + [f"{out}/nans.jsonl", "--num_epochs", "1",
                                       "--days_per_step", "5",
                                       "--save_dir", f"{out}/nans_models", "--debug_nans"])
    cli_out = {"launches": drive["launches"], "wall_s": drive["wall_s"],
               "prom_bytes": len(prom_text), "trace_summary_head": proc.stdout.splitlines()[:8],
               "report_flags": cflags, "overlap": overlap,
               "debug_nans": {"wall_s": nans["wall_s"],
                              "train_loss": _of(nans, "epoch")[0]["train_loss"]}}
    print(f"[obs] (c) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)

    # (d) the daemon: POST /profile around single-day and 34-day requests
    reg = ModelRegistry(device="cuda")
    mcfg = dataclasses.replace(base, train=dataclasses.replace(base.train, seed=seed))
    reg.register_params(load_model(mcfg, device="cuda"), mcfg, alias="m")
    daemon = ScoringDaemon(reg, dataset)
    daemon.handle_batch([{"model": "m", "day": dates[60]}])          # warm
    port, srv_thread = _start_front(serve_http, daemon, TickScheduler(daemon, tick_ms=2.0))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    status, body = _http(conn, "POST", "/profile",
                         {"action": "start", "log_dir": os.path.join(root, "daemon_prof")})
    check(status == 200, f"obs (d): POST /profile start {status} {body}")
    # a warm-up request inside the capture: CUPTI may miss a capture's first
    # launches; the requests after it are the counted ones
    status, body = _http(conn, "POST", "/score", {"id": -1, "model": "m", "day": dates[59]})
    check(status == 200 and json.loads(body)["ok"], f"obs (d): {body[:200]}")
    warm = {c.__name__: c.launches for c in counters}
    for c in counters:
        c.launches = 0
    for i in range(3):
        status, body = _http(conn, "POST", "/score", {"id": i, "model": "m",
                                                      "day": dates[60 + i]})
        check(status == 200 and json.loads(body)["ok"], f"obs (d): {body[:200]}")
    for i in range(2):
        status, body = _http(conn, "POST", "/score", {"id": 10 + i, "model": "m",
                                                      "start": dates[30], "end": dates[63]})
        check(status == 200 and json.loads(body)["ok"], f"obs (d): {body[:200]}")
    # every kernel row of the capture, so that no launch shape drops out
    status, body = _http(conn, "POST", "/profile", {"action": "stop", "top": 400})
    served = {c.__name__: c.launches for c in counters}
    _http(conn, "POST", "/score", {"cmd": "shutdown"})
    conn.close()
    srv_thread.join(60)
    answer = json.loads(body)
    check(status == 200 and answer["ok"] and answer["files"] >= 1,
          f"obs (d): POST /profile stop {status} {body[:400]}")
    drows = _kernel_rows([tuple(r) for r in answer["top"]])
    check(all(drows[n]["count"] >= served[n] for n in ("gru_fwd", "attention_fwd")),
          f"obs (d): the answer's rows {drows} vs the counters {served}")
    dcounted = {n: served[n] for n in ("gru_fwd", "attention_fwd")}
    dacct = _launch_accounting(answer["log_dir"], dcounted, warm)
    _check_counts("obs (d)", dacct, dcounted, warm)
    dsum = summarize_trace(answer["log_dir"], top=100000)
    host_names = {n for n, _, _ in dsum["host_by_name"]}
    daemon_out = {"launches": served, "top": answer["top"][:8], "kernels": {
        k: drows[k] for k in ("gru_fwd", "attention_fwd")}, "accounting": dacct,
        "total_us": answer["total_us"], "host_us": answer["host_us"],
        # the tick thread's CPU rows: its launch ranges and aten ops
        "tick_thread_cpu_rows": {"gru_fwd_range": "gru_fwd" in host_names,
                                 "attention_fwd_range": "attention_fwd" in host_names,
                                 "host_rows": len(host_names)}}
    print(f"[obs] (d) done at {time.perf_counter() - t_phase:.1f}s", file=sys.stderr)
    work.cleanup()
    return {"phase": "obs", "card": card,
            "config": "flagship C158/T20/H64/K96/M128, f32, 80 days x 300 stocks, "
                      "days_per_step=1",
            "launches": launches, "probes": probes, "profiler": profiler, "cli": cli_out,
            "daemon": daemon_out, "ledger": ledger_out,
            # K1's serving variant from the daemon's capture (one-day and
            # 32-day chunks), every other kernel from the training epoch's
            "profiler_us_per_launch": {k: v["us_per_launch"] or drows.get(k, {}).get(
                "us_per_launch") for k, v in krows.items()}}


# ---- rematerialized training and the factor decomposition -------------------

REMAT_RUNGS = ("none", "dots", "full")
REMAT_DAYS_PER_STEP = (1, 8)
REMAT_REPS = 6          # rounds of timed steps, the rungs in ABC CBA order, medians kept
REMAT_FLEET_LANES = 4


def _step_result(torch, state, aux) -> dict:
    """A step's loss, aux sums, gradients and generator state, on the host."""
    return {"loss": float(aux["loss_sum"] / aux["days"]),
            "aux": {k: v.detach().cpu() for k, v in aux.items() if torch.is_tensor(v)},
            "grads": {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
            "generator": state.generator.get_state().cpu()}


def _against(torch, got: dict, want: dict) -> dict:
    """`got` against `want` (two `_step_result`s): bitwise or not, and the
    largest relative gradient and loss differences."""
    same = (got["loss"] == want["loss"]
            and all(torch.equal(got["grads"][k], want["grads"][k]) for k in want["grads"])
            and all(torch.equal(got["aux"][k], want["aux"][k]) for k in want["aux"])
            and torch.equal(got["generator"], want["generator"]))
    grad = max(float((got["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
               for k, g in want["grads"].items() if float(g.abs().max()) > ZERO_GRAD_ATOL)
    return {"bitwise": bool(same), "loss_rel_err": abs(got["loss"] - want["loss"])
            / abs(want["loss"]), "grad_max_rel_err": grad}


def phase_remat(torch, seed: int, counters, card: str) -> dict:
    """Rematerialized training at flagship width (the module docstring's
    phase 18)."""
    import tempfile

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.train.fleet import FleetTrainer
    from factorvae_tpu_torch.train.loop import (
        day_noise,
        rematerialized,
        train_step,
        weighted_day_loss,
    )
    from factorvae_tpu_torch.train.trainer import Trainer, init_train_state

    base = get_preset("flagship")
    panel = synthetic_panel_dense(80, 300, base.model.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_remat_")
    dataset = PanelDataset(panel, seq_len=base.model.seq_len, device="cuda")
    cpu_ds = PanelDataset(panel, seq_len=base.model.seq_len, device="cpu")
    scale_cfg = (base.train.loss_scale_growth, base.train.loss_scale_backoff,
                 base.train.loss_scale_growth_interval, base.train.loss_scale_floor)

    def cfg_of(remat, dps=1, **model):
        return dataclasses.replace(
            base, model=dataclasses.replace(base.model, **model),
            data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                     val_start_time=dates[50], val_end_time=dates[69]),
            train=dataclasses.replace(base.train, seed=seed, num_epochs=1, days_per_step=dps,
                                      checkpoint_every=0, remat=remat,
                                      save_dir=os.path.join(work.name, remat)))

    def one_step(cfg, ds, device, days, dtype=torch.float32, terms=None):
        state = init_train_state(cfg.model, cfg.train, 100, device)
        handles = []
        if terms is not None:
            got, handles = _bias_terms(state.model)
        for c in counters:
            c.launches = 0
        aux = train_step(state, ds, days, guard=True, compute_dtype=dtype,
                         loss_scale_cfg=scale_cfg, remat=cfg.train.remat)
        for h in handles:
            h.remove()
        if terms is not None:
            terms.update(got)
        return state, _step_result(torch, state, aux), {c.__name__: c.launches
                                                        for c in counters}

    # (a) one step per rung at days_per_step 1 and 8 from the same init (the
    # preset's dropout and mse: the noise path), each against "none"; the
    # launches; the peak memory of a second step on that state
    steps, states = {}, {}
    for dps in REMAT_DAYS_PER_STEP:
        days = torch.arange(5, 5 + dps, device="cuda")
        ref = None
        for rung in REMAT_RUNGS:
            state, res, launched = one_step(cfg_of(rung, dps), dataset, "cuda", days)
            twice = 1 if rung == "none" else 2
            check(launched["gru_fwd_residuals"] == launched["attention_fwd"] == twice
                  and launched["gru_bwd"] == launched["gru_dwh"]
                  == launched["attention_bwd"] == 1 and launched["gru_fwd"] == 0,
                  f"remat (a): a {rung} step at days_per_step {dps} launched {launched}")
            ref = ref or res
            vs = _against(torch, res, ref)
            check(vs["loss_rel_err"] <= TRAIN_LOSS_RTOL
                  and vs["grad_max_rel_err"] <= TRAIN_GRAD_RTOL
                  and torch.equal(res["generator"], ref["generator"]),
                  f"remat (a): {rung} against none at days_per_step {dps}: {vs}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            train_step(state, dataset, days, guard=True, remat=rung)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            # what the forward leaves held for the backward, the one thing a
            # checkpoint around the whole day loss lowers
            eps, keep = day_noise(state.model, torch.Generator(device="cuda").manual_seed(seed),
                                  dps, dataset.values.shape[0], train=True, device="cuda")
            before = torch.cuda.memory_allocated()
            loss, _ = rematerialized(rung, weighted_day_loss, state.model, dataset, days,
                                     train=True, eps=eps, keep=keep)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - before
            del loss
            steps[f"dps{dps}_{rung}"] = {"launches": launched, "vs_none": vs,
                                         "peak_bytes": peak, "held_bytes": held}
            states[(dps, rung)] = state
    # card against CPU: a deterministic (dropout 0, nll) "full" step on the
    # card against the plain "none" step on the CPU (bitwise its "full":
    # tests/test_torch_remat.py), which records its bias terms, on the same
    # days at each days_per_step, at the train phase's limits
    card_cpu = {}
    for dps in REMAT_DAYS_PER_STEP:
        terms = {}
        res = {"cuda": one_step(cfg_of("full", dps, dropout_rate=0.0, recon_loss="nll"),
                                dataset, "cuda", torch.arange(5, 5 + dps, device="cuda"))[1],
               "cpu": one_step(cfg_of("none", dps, dropout_rate=0.0, recon_loss="nll"),
                               cpu_ds, "cpu", torch.arange(5, 5 + dps), terms=terms)[1]}
        loss_rel = abs(res["cuda"]["loss"] - res["cpu"]["loss"]) / abs(res["cpu"]["loss"])
        grad_errs, zero, zero_rows, cancelled = _grads_vs_cpu(
            torch, res["cuda"]["grads"], res["cpu"]["grads"], "remat", terms)
        card_cpu[f"dps{dps}_full"] = {
            "days": [5, 4 + dps], "loss_rel_err": loss_rel,
            "grad_max_rel_err": max(grad_errs.values()),
            "grad_errors_top": dict(sorted(grad_errs.items(), key=lambda kv: -kv[1])[:3]),
            "zero_grad_params": zero, "zero_grad_rows": zero_rows,
            "cancelled_biases": cancelled}
        check(loss_rel <= TRAIN_LOSS_RTOL and max(grad_errs.values()) <= TRAIN_GRAD_RTOL,
              f"remat (a): full at days_per_step {dps}, card vs CPU: {card_cpu[f'dps{dps}_full']}")
    # (b) step ms per rung on the warm states, ABC CBA, medians
    times = {f"dps{dps}_{r}": [] for dps in REMAT_DAYS_PER_STEP for r in REMAT_RUNGS}
    for rep in range(REMAT_REPS):
        for dps in REMAT_DAYS_PER_STEP:
            days = torch.arange(5, 5 + dps, device="cuda")
            for rung in (REMAT_RUNGS if rep % 2 == 0 else REMAT_RUNGS[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(states[(dps, rung)], dataset, days, guard=True, remat=rung)
                torch.cuda.synchronize()
                times[f"dps{dps}_{rung}"].append((time.perf_counter() - t0) * 1e3)
    for key, vals in times.items():
        steps[key]["step_ms"] = float(np.median(vals))
        steps[key]["step_ms_all"] = vals
    # (c) a mixed step under "dots" against "none"
    mixed_cfg = {r: dataclasses.replace(cfg_of(r), model=dataclasses.replace(
        base.model, compute_dtype="bfloat16")) for r in ("none", "dots")}
    days = torch.arange(5, 6, device="cuda")
    _, mixed_none, _ = one_step(mixed_cfg["none"], dataset, "cuda", days, torch.bfloat16)
    _, mixed_dots, mixed_launched = one_step(mixed_cfg["dots"], dataset, "cuda", days,
                                             torch.bfloat16)
    mixed = _against(torch, mixed_dots, mixed_none)
    check(mixed["loss_rel_err"] <= TRAIN_LOSS_RTOL and mixed["grad_max_rel_err"] <= TRAIN_GRAD_RTOL
          and mixed_launched["gru_fwd_residuals"] == 2,
          f"remat (c): a mixed step under dots {mixed}, launches {mixed_launched}")
    # (d) a seed fleet of four under "full" against "none", one epoch
    seeds = list(range(seed, seed + REMAT_FLEET_LANES))
    fleets = {}
    for rung in ("none", "full"):
        for c in counters:
            c.launches = 0
        fstate, fout = FleetTrainer(cfg_of(rung), dataset, seeds=seeds, device="cuda").fit()
        fleets[rung] = (fstate, fout, {c.__name__: c.launches for c in counters})
    fparams = {k: (fleets["full"][0].params[k] - v).abs().max().item()
               for k, v in fleets["none"][0].params.items()}
    fleet_bitwise = all(torch.equal(fleets["full"][0].params[k], v)
                        for k, v in fleets["none"][0].params.items())
    fleet_steps = 50
    check(fleets["full"][2]["gru_fwd_residuals"] == 2 * fleet_steps
          and fleets["full"][2]["gru_bwd"] == fleet_steps,
          f"remat (d): a fleet epoch under full launched {fleets['full'][2]}")
    check(max(fparams.values()) <= TRAIN_PARAM_ATOL,
          f"remat (d): the fleet's parameters differ from none's by {max(fparams.values())}")
    # (e) one warm Trainer epoch per rung; the "full" epoch's launches are
    # the phase's
    epochs, launches = {}, None
    for rung in REMAT_RUNGS:
        tr = Trainer(cfg_of(rung), dataset, device="cuda")
        tr.fit()
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        _, out = tr.fit()
        torch.cuda.synchronize()
        rec = out["history"][0]
        check(np.isfinite(rec["train_loss"]) and rec["skipped_steps"] == 0,
              f"remat (e): the {rung} epoch {rec}")
        epochs[rung] = {"epoch_s_warm": rec["seconds"], "train_loss": rec["train_loss"],
                        "val_loss": rec["val_loss"]}
        if rung == "full":
            launches = {c.__name__: c.launches for c in counters}
            n, val = tr.steps_per_epoch, -(-len(tr.val_days) // tr.batch_days)
            check(launches["gru_fwd_residuals"] == 2 * n and launches["gru_bwd"] == n
                  and launches["gru_dwh"] == n and launches["attention_bwd"] == n
                  and launches["attention_fwd"] == 2 * n + val and launches["gru_fwd"] == val,
                  f"remat (e): {n} steps, {val} validation batches, {launches}")
    for rung in ("dots", "full"):
        rel = abs(epochs[rung]["train_loss"] - epochs["none"]["train_loss"]) / abs(
            epochs["none"]["train_loss"])
        epochs[rung]["train_loss_rel_err_vs_none"] = rel
        check(rel <= TRAIN_LOSS_RTOL, f"remat (e): the {rung} epoch's loss differs from "
                                      f"none's by {rel}")
    work.cleanup()
    return {"phase": "remat", "card": card,
            "config": "flagship C158/T20/H64/K96/M128, f32 (mixed: bf16 compute), dropout "
                      "0.1, mse, 80 days x 300 stocks",
            "steps": steps,
            "limits": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
                       "sum_rtol": SUM_RTOL},
            "card_vs_cpu": card_cpu,
            "mixed_dots_vs_none": mixed,
            "fleet_full_vs_none": {"lanes": REMAT_FLEET_LANES, "bitwise": fleet_bitwise,
                                   "param_max_abs_err": max(fparams.values()),
                                   "limit": TRAIN_PARAM_ATOL,
                                   "launches_full": fleets["full"][2]},
            "epochs": epochs, "launches": launches}


FACTORS_DAYS = 34          # crosses a 32-day chunk
FACTORS_TOL = 1e-5         # card vs CPU frames, max |a - b| / max(1, max |b|)
FACTORS_REPS = 5


def phase_factors(torch, seed: int, counters, card: str) -> dict:
    """`eval.factors.decompose` at flagship width (the module docstring's
    phase 19)."""
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.factors import decompose
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.presets import get_preset

    cfg = get_preset("flagship")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
    panel = synthetic_panel_dense(80, 300, cfg.model.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    start, end = dates[40], dates[40 + FACTORS_DAYS - 1]
    dataset = PanelDataset(panel, seq_len=cfg.model.seq_len, device="cuda")
    model = load_model(cfg, device="cuda")
    decompose(model, cfg, dataset, start=start, end=end)               # warm
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    got = decompose(model, cfg, dataset, start=start, end=end)
    torch.cuda.synchronize()
    range_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    chunks = -(-FACTORS_DAYS // 32)
    check(launches["gru_fwd"] == launches["attention_fwd"] == chunks
          and all(launches[n] == 0 for n in ("gru_fwd_residuals", "gru_bwd", "gru_dwh",
                                             "attention_bwd")),
          f"factors: {chunks} chunks but launches {launches}")
    n_valid = int(panel.valid[40:40 + FACTORS_DAYS].sum())
    k = cfg.model.num_factors
    check(got["factors"].shape == (FACTORS_DAYS * k, 4)
          and got["exposures"].shape == (n_valid, k + 2)
          and got["loss"].shape == (FACTORS_DAYS, 3)
          and all(np.isfinite(f.to_numpy()).all() for f in got.values()),
          f"factors: frames {[f.shape for f in got.values()]}")
    cpu = decompose(load_model(cfg, device="cpu"), cfg,
                    PanelDataset(panel, seq_len=cfg.model.seq_len, device="cpu"),
                    start=start, end=end)
    errs = {}
    for name, cols in (("factors", None), ("exposures", None), ("loss", ["kl"])):
        a, b = got[name], cpu[name]
        check(a.index.equals(b.index) and list(a.columns) == list(b.columns),
              f"factors: the {name} frames' index or columns differ")
        a, b = (a.to_numpy() if cols is None else a[cols].to_numpy(),
                b.to_numpy() if cols is None else b[cols].to_numpy())
        errs[name] = float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))
    check(max(errs.values()) <= FACTORS_TOL, f"factors: card vs CPU {errs} > {FACTORS_TOL}")
    # ms per chunk: one full 32-day chunk, repeated
    one = []
    for _ in range(FACTORS_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decompose(model, cfg, dataset, start=dates[40], end=dates[71])
        torch.cuda.synchronize()
        one.append((time.perf_counter() - t0) * 1e3)
    return {"phase": "factors", "card": card,
            "config": "flagship C158/T20/H64/K96/M128, f32, mse, 80 days x 300 stocks, "
                      f"a {FACTORS_DAYS}-day range in 32-day chunks",
            "launches": launches, "chunks": chunks, "range_s": range_s,
            "chunk_ms": float(np.median(one)), "chunk_ms_all": one,
            "rows": {name: len(f) for name, f in got.items()},
            "card_vs_cpu": errs, "tolerance": FACTORS_TOL,
            "card_vs_cpu_compared": "factors, exposures, loss.kl (the recon column takes "
                                    "the decoder's sampled draw, the card's and the CPU's "
                                    "generators differ)"}


PLAN_DAYS = 8              # the autotune tool's --days and --reps (its defaults)
PLAN_REPS = 2
PLAN_CLI_DAYS = 60         # 30 train + 10 validation + 20 scored days
PLAN_SERVE_ROW = {"precision": "bfloat16", "tick_ms": 5.0, "max_tick_batch": 16,
                  "slo_ms": 50.0, "hedge_ms": 3.0}


def _autotune(torch, counters, argv, what: str = "plan (a)") -> tuple:
    """`python -m factorvae_tpu_torch.autotune ARGV` in this process (its
    rows' JSON and its progress kept, not printed) with every launch
    counter set to 0 just before; (rows, launches, wall_s, progress)."""
    import contextlib
    import io

    from factorvae_tpu_torch import autotune

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = autotune.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"{what}: autotune {' '.join(argv)} exited {rc}:\n{err.getvalue()[-4000:]}")
    return (json.loads(out.getvalue())["rows"], {c.__name__: c.launches for c in counters},
            wall, err.getvalue().splitlines())


def _defaults_held(r: dict, races: tuple) -> list:
    """The races of row `r` whose measured candidates lack the default."""
    m = r["measured"]
    want = {"train": "flat=1_dps1_float32", "score": "flat=1_float32", "fleet": "S=1",
            "hyper": "S=1", "stream": "hbm", "train_remat": "none"}
    missing = [k for k in races if k in want and want[k] not in m.get(k, {})]
    if "serve" in races and "float32" not in m["serve"]["rates"]:
        missing.append("serve")
    if "train_precision" in races and m["train_precision"]["s_per_day"]["float32"] is None:
        missing.append("train_precision")
    return missing


def phase_plan(torch, seed: int, counters, card: str) -> dict:
    """The execution planner on the card (the module docstring's phase 20)."""
    import signal
    import tempfile

    from factorvae_tpu_torch import cli
    from factorvae_tpu_torch import plan as planlib
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import panel_to_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.params import save_weights
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.__main__ import build_parser, fleet_plan_defaults
    from factorvae_tpu_torch.serve.pool import free_port

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_plan_")
    root = work.name
    table = os.path.join(root, "plan_table.json")
    knobs = ["--device", "cuda", "--days", str(PLAN_DAYS), "--reps", str(PLAN_REPS),
             "--out", table]
    # (a) the races: every block at flagship width (300 and 356 stocks), then
    # the train race alone at the alpha360-k60 shape (T = 60: K3's walk)
    races = ("train", "score", "fleet", "hyper", "stream", "serve", "train_precision",
             "train_remat")
    flag_rows, l_flag, flag_s, progress = _autotune(
        torch, counters, ["--config", "flagship", "--fleet", "--hyper", "--stream",
                          "--serve", "--train_precision", "--remat", *knobs])
    k60_rows, l_k60, k60_s, _ = _autotune(torch, counters,
                                          ["--config", "alpha360-k60", *knobs])
    launches = {k: l_flag[k] + l_k60[k] for k in l_flag}
    check(all(v > 0 for v in l_flag.values()),
          f"plan (a): a kernel was not launched by the flagship races: {l_flag}")
    check(all(l_k60[k] > 0 for k in ("gru_fwd_residuals", "gru_bwd", "gru_dwh",
                                     "attention_fwd", "attention_bwd")),
          f"plan (a): the alpha360-k60 train race at T = 60 launched {l_k60}")
    for rows, held in ((flag_rows, races), (k60_rows, ("train", "score"))):
        for r in rows:
            per_width = ([v for k, v in r["measured"].items() if k.startswith("n=")]
                         or [r["measured"]])
            for m in per_width:
                missing = _defaults_held({**r, "measured": m}, held)
                check(not missing, f"plan (a): row {r['n_min']}-{r['n_max']} lacks the "
                                   f"default candidate of {missing}")
    table_rows = planlib.load_table(table)
    check(len(table_rows) == len(flag_rows) + len(k60_rows)
          and all(card in r["source"] for r in table_rows),
          f"plan (a): the table holds {len(table_rows)} rows")
    flag300 = next(r for r in flag_rows if r["n_min"] <= 300 <= r["n_max"])
    winners = [{k: r.get(k) for k in ("n_min", "n_max", "train", "score", "fleet", "hyper",
                                      "stream", "serve", "train_precision", "train_remat")}
               for r in flag_rows + k60_rows]

    # (b) the CLI with --auto_plan against that table, and the same knobs
    # given as flags
    cfg = get_preset("flagship")
    panel = synthetic_panel_dense(PLAN_CLI_DAYS, 300, cfg.model.num_features, seed=seed)
    d = [str(x) for x in panel.dates]
    pkl = os.path.join(root, "panel.pkl")
    panel_to_frame(panel).to_pickle(pkl)
    m = cfg.model
    base = ["--dataset", pkl, "--num_latent", str(m.num_features), "--hidden_size",
            str(m.hidden_size), "--num_factor", str(m.num_factors), "--num_portfolio",
            str(m.num_portfolios), "--seq_len", str(m.seq_len),
            "--device", "cuda", "--seed", str(seed), "--run_name", "plan", "--num_epochs", "1",
            "--start_time", d[0], "--fit_end_time", d[29], "--val_start_time", d[30],
            "--val_end_time", d[39], "--score_start", d[40], "--score_end", d[-1]]

    def argv(out, *extra):
        return base + ["--save_dir", f"{root}/{out}/models", "--score_dir",
                       f"{root}/{out}/scores", "--metrics_jsonl", f"{root}/{out}/run.jsonl",
                       *extra]

    no_rows = os.environ.get(planlib.PLAN_TABLE_ENV)     # main's empty table
    os.environ[planlib.PLAN_TABLE_ENV] = table
    try:
        auto = _cli_drive(torch, cli, counters, argv("auto", "--auto_plan"))
    finally:
        os.environ[planlib.PLAN_TABLE_ENV] = no_rows
    (rec,) = _of(auto, "plan")
    pl = planlib.plan_for_config(cfg, 300, platform="cuda", table=[flag300])
    check(rec["provenance"] == "measured" and rec["source"] == flag300["source"]
          and all(rec[k] == v for k, v in pl.to_dict().items())
          and rec["kernels_resolved"] == {"attention": "cuda", "gru": "cuda"},
          f"plan (b): the plan record {rec} is not the row's {pl}")
    (layout,) = _of(auto, "execution_layout")
    train_dtype = pl.train_compute_dtype or pl.compute_dtype
    check((layout["days_per_step"], layout["compute_dtype"], layout["n_padded"])
          == (pl.days_per_step, train_dtype, pl.pad_target) and pl.pad_target == 300,
          f"plan (b): trained with {layout}, the row says {pl}")
    check(all(v > 0 for v in auto["launches"].values()),
          f"plan (b): launches {auto['launches']}")
    flags = ["--days_per_step", str(pl.days_per_step), "--max_stocks", str(pl.pad_target),
             "--panel_residency", pl.panel_residency, "--stream_chunk_days",
             str(pl.stream_chunk_days), "--bf16" if train_dtype == "bfloat16" else "--no-bf16"]
    explicit = _cli_drive(torch, cli, counters, argv("flags", *flags))
    if pl.score_compute_dtype != train_dtype:     # no flag sets the scoring dtype alone
        explicit = _cli_drive(torch, cli, counters, argv(
            "flags", *flags[:-1], "--score_only",
            "--bf16" if pl.score_compute_dtype == "bfloat16" else "--no-bf16"))
    auto_csv, flags_csv = _of(auto, "scores")[0]["path"], _of(explicit, "scores")[0]["path"]
    with open(auto_csv, "rb") as a, open(flags_csv, "rb") as b:
        csv_equal = a.read() == b.read()
    check(csv_equal, f"plan (b): {auto_csv} and {flags_csv} differ")

    # (c) --compile_cache DIR in two fresh processes
    cache = os.path.join(root, "compile_cache")
    repo = os.path.dirname(os.path.abspath(__file__))
    proc_runs = []
    for i in range(2):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "factorvae_tpu_torch.cli",
                            *argv(f"cache{i}", "--compile_cache", cache)],
                           cwd=repo, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"plan (c): process {i} exited {r.returncode}:\n"
                                 f"{r.stderr[-3000:]}")
        with open(f"{root}/cache{i}/run.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        proc_runs.append({"wall_s": wall,
                          "compile": len([e for e in events if e["event"] == "compile"]),
                          "compile_cached": len([e for e in events
                                                 if e["event"] == "compile_cached"]),
                          "compile_cache": [e["dir"] for e in events
                                            if e["event"] == "compile_cache"]})
    libs = sorted(f for f in os.listdir(cache) if f.endswith(".so"))
    # the kernels' four libraries, and the native panel ops' one (built
    # into the same directory, outside the compile counts)
    kernel_libs = [f for f in libs if not f.startswith("libpanelops-")]
    check(proc_runs[0]["compile"] == 4 and proc_runs[0]["compile_cached"] == 0
          and proc_runs[1]["compile"] == 0 and proc_runs[1]["compile_cached"] == 4
          and len(kernel_libs) == 4 and len(libs) == 5
          and all(p["compile_cache"] == [cache] for p in proc_runs),
          f"plan (c): {proc_runs}, libraries {libs}")

    # (d) serve --precision plan against a row with a bf16 serve block
    serve_table = os.path.join(root, "serve_table.json")
    planlib.save_rows([{**flag300, "serve": PLAN_SERVE_ROW}], path=serve_table)
    weights = save_weights(load_model(cfg, device="cuda"), cfg, os.path.join(root, "w0"))
    env = {**os.environ, planlib.PLAN_TABLE_ENV: serve_table}
    port = free_port()
    proc = subprocess.Popen([sys.executable, "-m", "factorvae_tpu_torch.serve", "--model",
                             weights, "--synthetic", "40,300", "--max_stocks", "300",
                             "--http", str(port), "--scheduler"], cwd=repo, env=env,
                            stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
    lines = []
    try:
        while True:
            line = proc.stderr.readline()
            check(line != "", f"plan (d): the daemon exited early:\n{''.join(lines)}")
            lines.append(line)
            if "/score" in line:
                break
        import http.client

        def score():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("POST", "/score", headers={"Content-Type": "application/json"},
                             body=json.dumps({"id": 1, "model": "w0", "day": 30}))
                return json.loads(conn.getresponse().read())
            finally:
                conn.close()

        deadline = time.monotonic() + 60      # the line comes just before it listens
        while True:
            try:
                resp = score()
                break
            except ConnectionRefusedError:
                check(time.monotonic() < deadline, "plan (d): the daemon never listened")
                time.sleep(0.1)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    admitted = [x for x in lines if "[serve] admitted" in x]
    sched = [x for x in lines if "continuous batching" in x]
    os.environ[planlib.PLAN_TABLE_ENV] = serve_table
    try:
        slo_hedge = fleet_plan_defaults(build_parser().parse_args(
            ["--model", weights, "--synthetic", "40,300", "--workers", "2"]), 300)
    finally:
        os.environ[planlib.PLAN_TABLE_ENV] = no_rows
    check(len(admitted) == 1 and "bfloat16" in admitted[0]
          and resp.get("ok") and str(resp.get("model", "")).endswith(":bfloat16")
          and sched == ["[serve] continuous batching: tick_ms=5 max_tick_batch=16\n"]
          and slo_hedge == (50.0, 3.0),
          f"plan (d): {admitted}, {sched}, response ok={resp.get('ok')} "
          f"model={resp.get('model')}, fleet (slo, hedge) {slo_hedge}")

    # (e) flagship scores at the plan's pad (300) against pad_multiple 8's 304
    model = load_model(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                          seed=seed)),
                       device="cuda")
    days = np.arange(20, 52)
    pads = {}
    for n_max in (300, None):
        ds = PanelDataset(panel, seq_len=cfg.model.seq_len, max_stocks=n_max, device="cuda")
        pads[ds.n_max] = predict_panel(model, cfg, ds, days, stochastic=False)
    a, b = pads[300], pads[304][:, :300]
    check(np.isfinite(a).all() and np.isnan(pads[304][:, 300:]).all(),
          "plan (e): the scores are not finite where the panel is valid")
    pad_err = float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))
    check(pad_err <= SLICE_TOL, f"plan (e): pad 300 vs 304: {pad_err} > {SLICE_TOL}")
    work.cleanup()
    return {"phase": "plan", "card": card,
            "config": f"autotune --days {PLAN_DAYS} --reps {PLAN_REPS}: flagship "
                      "C158/T20/H64/K96/M128 at 300 and 356 stocks (every race), "
                      "alpha360-k60 C360/T60/H60/K60/M128 at 300 (train and score); the CLI "
                      f"on a {PLAN_CLI_DAYS}-day pickle of 300 stocks, one epoch",
            "launches": launches, "launches_races_flagship": l_flag,
            "launches_races_alpha360_k60": l_k60, "launches_auto_plan_cli": auto["launches"],
            "races_s": {"flagship": flag_s, "alpha360_k60": k60_s},
            "winners": winners,
            "sources": [r["source"] for r in flag_rows + k60_rows],
            "_rows": flag_rows + k60_rows, "_progress": progress,
            "auto_plan": {"plan": {k: rec[k] for k in pl.to_dict()},
                          "execution_layout": {k: layout[k] for k in (
                              "days_per_step", "compute_dtype", "n_padded")},
                          "csv_byte_equal_to_flags": csv_equal, "flags": flags,
                          "wall_s": auto["wall_s"]},
            "compile_cache": {"processes": proc_runs, "libraries": libs},
            "serve_plan": {"admitted": admitted[0].strip(), "scheduler": sched[0].strip(),
                           "fleet_slo_hedge_ms": slo_hedge, "row_serve": PLAN_SERVE_ROW},
            "pad_300_vs_304": {"max_rel_err": pad_err, "tolerance": SLICE_TOL,
                               "days": len(days)}}


# ---- mesh: parallelism on torch.distributed ---------------------------------

MESH_STEPS = 4          # updates of days_per_step 2 per mesh run
MESH_SCORE_DAYS = 34    # 1 x 2 scoring: a 32-day chunk and a padded one
MESH_RACE_DAYS = 4      # the (d) race's synthetic panel days (`autotune --days`)
# Mesh against serial on the card, from the same weights, at the CPU tests'
# tolerances (tests/test_torch_parallel.py): the first update's gradients
# (the GRU's weights at GRU_MESH_TOL), the parameters after it where the
# serial gradient exceeds the atol (elsewhere within 2 lr: Adam's first
# step is +-lr whatever the gradient), each step's loss, and the 1 x 2
# scores.
MESH_TOL = dict(rtol=1e-5, atol=1e-6)
GRU_MESH_TOL = dict(rtol=2e-5, atol=5e-6)
MESH_LOSS_RTOL = 2e-5


def _mesh_setup(seed: int):
    """(config, panel) of the mesh phase: the flagship preset on the 80-day
    panel of 300 stocks, days_per_step 2, padded to 300 (pad_multiple 2),
    so each of two 'stock' ranks holds 150 rows."""
    import tempfile

    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.presets import get_preset

    base = get_preset("flagship")
    panel = synthetic_panel_dense(80, 300, base.model.num_features, seed=seed)
    dates = [str(d) for d in panel.dates]
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                 val_start_time=dates[50], val_end_time=dates[69],
                                 pad_multiple=2),
        train=dataclasses.replace(base.train, seed=seed, num_epochs=1, days_per_step=2,
                                  checkpoint_every=0,
                                  save_dir=tempfile.mkdtemp(prefix="chip_smoke_mesh_")))
    return cfg, panel


def _mesh_run(torch, cfg, panel, mesh, counters) -> dict:
    """MESH_STEPS updates of the epoch-0 order on `mesh` (None: serial),
    every launch counter set to 0 just before them, the rows each launch of
    K1's residual variant was given recorded (at its `_fwd_launch`); then, on a mesh with a 'stock' axis, the
    scores of MESH_SCORE_DAYS days from the seed's weights."""
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.obs.comms import comms_block
    from factorvae_tpu_torch.ops.kernels import gru as gru_mod
    from factorvae_tpu_torch.parallel.collective_ops import comm_counts
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    ds = PanelDataset(panel, seq_len=cfg.data.seq_len, pad_multiple=cfg.data.pad_multiple,
                      device="cuda")
    tr = Trainer(cfg, ds, device="cuda", mesh=mesh)
    state = tr.init_state()
    order = tr._order(tr.train_days, True, 0)
    rows = []
    real = gru_mod._fwd_launch

    def recording(name, xi, *a, **kw):
        if name == "gru_fwd_residuals":
            rows.append(int(xi.shape[-3]))
        return real(name, xi, *a, **kw)

    gru_mod._fwd_launch = recording
    before = comm_counts()
    losses, walls, first = [], [], None
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            aux = train_step(state, tr.ds, order[i], guard=True, mesh=tr.mesh_step)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if tr.mesh_step is not None:
                aux = tr.mesh_step.reduce_sums(aux)
            losses.append(float(aux["loss_sum"] / aux["days"]))
            if i == 0:
                first = {
                    "grads": {n: p.grad.detach().cpu().numpy().copy()
                              for n, p in state.model.named_parameters()},
                    "params": {n: p.detach().cpu().numpy().copy()
                               for n, p in state.model.named_parameters()}}
    finally:
        gru_mod._fwd_launch = real
    launches = {c.__name__: c.launches for c in counters}
    out = {"losses": losses, "first": first, "launches": launches, "k1_rows": rows,
           "step_wall_s": walls, "n_local": int(ds.values.shape[0]),
           "params": {n: p.detach().cpu().numpy().copy()
                      for n, p in state.model.named_parameters()},
           "comms": comms_block(comm_counts(), before, mesh=mesh, steps=MESH_STEPS,
                                steps_per_epoch=tr.steps_per_epoch) if mesh else None}
    if mesh is None or mesh.shape.get("stock", 1) > 1:
        days = tr.train_days[:MESH_SCORE_DAYS]
        t0 = time.perf_counter()
        out["scores"] = predict_panel(load_model(cfg, device="cuda"), cfg, ds, days,
                                      stochastic=False, mesh=mesh)
        torch.cuda.synchronize()
        out["score_s"] = time.perf_counter() - t0
    return out


# Fleets on the meshes of phase (c): a hyper-fleet of two lanes (lr, kl_weight
# per lane) and a PBT of four, both at 2 x 1, and a seed fleet of two on
# 'host' 2 x 'data' 1 x 'stock' 1. Lane parameters are held to the card's
# fleet tolerance, TRAIN_PARAM_ATOL: the remat phase holds a 50-step fleet
# epoch to it against a run of the same epoch, the train phase 8 card steps
# against the CPU's. On the CPU the same paths hold at rtol 2e-5 / atol
# 2e-6 (tests/test_torch_mesh_fleets.py, MESH_FLEET_TOL here, whose
# exceedances are counted): there the rounding of the vmapped products does
# not depend on the lanes in a program, while cuBLAS may choose another
# algorithm for 2 lanes than for 4, and Adam's steps carry the difference
# through every later update. Where Adam turns rounding into steps (an
# element whose gradient lies within 10 Adam eps of zero moves by
# lr * g / (|g| + eps), so a rounding difference of 1e-9 in g moves it by up
# to lr), the element is held to lr at every step of the run and counted:
# the two leaves whose gradient is zero in exact arithmetic, and an element
# whose first-step gradient or whose run's RMS gradient (Adam's
# bias-corrected second moment in the serial run) is within
# MESH_FLEET_NOISE of zero.
MESH_FLEET_TOL = dict(rtol=2e-5, atol=2e-6)
MESH_FLEET_ZERO_GRAD = ("factor_encoder.portfolio.bias", "factor_predictor.key_bias")
MESH_FLEET_NOISE = 1e-7     # 10 x Adam's eps
ADAM_BETA2 = 0.999
MESH_PBT_GENERATIONS = 2


def _mesh_lanes(cfg, seed: int) -> dict:
    """(seed, lr, kl_weight) of each lane of the phase (c) fleets."""
    lr = cfg.train.lr
    return {"hyper": [(seed, lr, 1.0), (seed + 1, 2 * lr, 0.5)],
            "pbt": [(seed, lr, 1.0), (seed + 1, 2 * lr, 0.5), (seed + 2, 0.5 * lr, 2.0),
                    (seed + 3, 3 * lr, 0.25)],
            "hier": [(seed, lr, 1.0), (seed + 1, lr, 1.0)]}


def _lane_cfgs(cfg, lanes, save_dir: str, **train) -> tuple:
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, save_dir=save_dir,
                                                             **train))
    return cfg, [dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, kl_weight=float(klw)),
        train=dataclasses.replace(cfg.train, seed=int(s), lr=float(lr),
                                  run_name=f"{cfg.train.run_name}_lane{i}"))
        for i, (s, lr, klw) in enumerate(lanes)]


def _np_tree(tree) -> dict:
    return {n: p.detach().cpu().numpy().copy() for n, p in tree.items()}


def _mesh_fleet_runs(torch, cfg, panel, root: str, counters, hier_mesh=None,
                     mesh=None, device: str = "cuda") -> dict:
    """The phase (c) fleets on the card: without a mesh (the serial
    reference), or on `mesh` (2 x 1) and `hier_mesh`; every launch counter
    set to 0 just before each run."""
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.obs.comms import comms_block
    from factorvae_tpu_torch.parallel.collective_ops import comm_counts
    from factorvae_tpu_torch.train.fleet import FleetTrainer
    from factorvae_tpu_torch.train.pbt import pbt_fit

    lanes = _mesh_lanes(cfg, cfg.train.seed)
    tag = "serial" if mesh is None else "mesh"

    def ds():
        return PanelDataset(panel, seq_len=cfg.data.seq_len,
                            pad_multiple=cfg.data.pad_multiple, device=device)

    def run(fn, on):
        torch.cuda.synchronize()
        before = comm_counts()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.update(wall_s=wall, launches={c.__name__: c.launches for c in counters},
                   comms=comms_block(comm_counts(), before, mesh=on, steps=out["steps"],
                                     steps_per_epoch=out["steps_per_epoch"]) if on else None)
        return out

    def rms_grad(state):
        # Adam's bias-corrected second moment: each element's RMS gradient
        t = torch.as_tensor(state.counts, dtype=torch.float64)
        fix = 1.0 - ADAM_BETA2 ** t
        return {n: (v.double() / fix.to(v.device).view((-1,) + (1,) * (v.ndim - 1)))
                .sqrt().cpu().numpy() for n, v in state.exp_avg_sq.items()}

    def fleet(run_cfg, on, **kw):
        trainer = FleetTrainer(run_cfg, ds(), device=device, mesh=on, **kw)
        state, fit = trainer.fit()
        return {"rms_grad": rms_grad(state) if on is None else None,
                "history": [(h["train_loss"], h["val_loss"]) for h in fit["history"]],
                "best_val": [float(v) for v in fit["best_val"]],
                "final": _np_tree(fit["final_params"]), "best": _np_tree(fit["best_params"]),
                "hyper": trainer.hyper, "lanes": (trainer.lanes.start, trainer.lanes.stop),
                "steps": trainer.steps_per_epoch * run_cfg.train.num_epochs,
                "steps_per_epoch": trainer.steps_per_epoch}

    def pbt(on):
        pcfg, plane = _lane_cfgs(cfg, lanes["pbt"], os.path.join(root, tag, "pbt"),
                                 checkpoint_every=1)
        trainer, res = pbt_fit(pcfg, ds(), plane, generations=MESH_PBT_GENERATIONS,
                               epochs_per_generation=1, device=device, mesh=on)
        return {"rms_grad": rms_grad(res["state"]) if on is None else None,
                "generations": [{k: g[k] for k in ("generation", "fitness", "winners",
                                                  "exploited")}
                                for g in res["generations"]],
                "scalars": [(c.train.lr, c.model.kl_weight) for c in res["lane_configs"]],
                "best_val": [float(v) for v in res["best_val"]],
                "best": _np_tree(res["best_params"]),
                "final": _np_tree({n: trainer._gather_lanes(p)
                                   for n, p in res["state"].params.items()}),
                "steps": trainer.steps_per_epoch * MESH_PBT_GENERATIONS,
                "steps_per_epoch": trainer.steps_per_epoch}

    hcfg, hlanes = _lane_cfgs(cfg, lanes["hyper"], os.path.join(root, tag, "hyper"))
    fcfg, _ = _lane_cfgs(cfg, lanes["hier"], os.path.join(root, tag, "hier"))
    return {
        "hyper": run(lambda: fleet(hcfg, mesh, lane_configs=hlanes), mesh),
        "pbt": run(lambda: pbt(mesh), mesh),
        "hier": run(lambda: fleet(fcfg, hier_mesh, seeds=[s for s, _, _ in lanes["hier"]]),
                    hier_mesh),
    }


def _first_step_noise(torch, cfg, panel, root: str, device: str = "cuda") -> dict:
    """{name: elements whose gradient in some phase (c) lane's first step
    (its solo run's, on the card) lies within MESH_FLEET_NOISE of zero}."""
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    ds = PanelDataset(panel, seq_len=cfg.data.seq_len, pad_multiple=cfg.data.pad_multiple,
                      device=device)
    noise: dict = {}
    seen = set()
    for lanes in _mesh_lanes(cfg, cfg.train.seed).values():
        _, cfgs = _lane_cfgs(cfg, lanes, os.path.join(root, "noise"))
        for lane in cfgs:
            key = (lane.train.seed, lane.model.kl_weight)
            if key in seen:
                continue
            seen.add(key)
            tr = Trainer(lane, ds, device=device)
            state = tr.init_state()
            train_step(state, tr.ds, tr._order(tr.train_days, True, 0)[0], guard=True)
            for n, p in state.model.named_parameters():
                small = (p.grad.abs() <= MESH_FLEET_NOISE).cpu().numpy()
                noise[n] = noise.get(n, small) | small
    return noise


def _fleet_params_check(got: dict, want: dict, noise: dict, rms: dict, lr_max: float,
                        steps: int, what: str) -> tuple:
    """Lane parameters of a mesh run against the serial run's (the fleet
    tolerance above): (the largest errors, the failures)."""
    err, noise_err, counted, beyond_cpu_tol, failures = 0.0, 0.0, 0, 0, []
    for n, w in want.items():
        diff = np.abs(got[n] - w)
        mask = np.broadcast_to(noise[n], w.shape) | (rms[n] <= MESH_FLEET_NOISE)
        if n in MESH_FLEET_ZERO_GRAD:
            mask = np.ones_like(mask)
        ok = np.where(mask, diff <= lr_max * steps, diff <= TRAIN_PARAM_ATOL)
        beyond_cpu_tol += int((~mask & ~np.isclose(got[n], w, **MESH_FLEET_TOL)).sum())
        if not ok.all():
            worst = np.unravel_index(np.argmax(np.where(ok, -1.0, diff)), w.shape)
            failures.append(f"{what} {n}: {int((~ok).sum())} of {ok.size} off, worst "
                            f"{float(diff[worst])} at {tuple(int(i) for i in worst)} "
                            f"(value {float(w[worst])}, RMS gradient {float(rms[n][worst])})")
        err = max(err, float(diff[~mask].max(initial=0.0)))
        noise_err = max(noise_err, float(diff[mask].max(initial=0.0)))
        counted += int(mask.sum())
    return ({"param_max_abs_err": err, "noise_param_max_abs_err": noise_err,
             "noise_elements": counted, "elements_beyond_cpu_tol": beyond_cpu_tol},
            failures)


def _mesh_fleet_check(serial: dict, ranks: list, noise: dict, cfg) -> dict:
    """Phase (c): the ranks bitwise each other on every shared leaf, each run
    against the serial one on the card; K1, K2, K4 and K5 on every rank."""
    lr_max = 3 * cfg.train.lr * 1.25
    out, failures = {}, []
    for key in ("hyper", "pbt", "hier"):
        want, r0 = serial[key], ranks[0][key]
        for r, got in enumerate(ranks):
            for name in ("gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_fwd",
                         "attention_bwd"):
                check(got[key]["launches"][name] > 0,
                      f"mesh (c) {key}: rank {r} never launched {name}")
            for leaf in ("final", "best"):
                for n, p in r0[leaf].items():
                    check(np.array_equal(got[key][leaf][n], p),
                          f"mesh (c) {key}: ranks disagree on {leaf} {n}")
            for field in ("best_val", "history", "generations", "scalars"):
                check(got[key].get(field) == r0.get(field),
                      f"mesh (c) {key}: ranks disagree on {field}")
        loss_rel = 0.0
        if key == "pbt":
            for g, w in zip(r0["generations"], want["generations"], strict=True):
                check(g["winners"] == w["winners"] and g["exploited"] == w["exploited"],
                      f"mesh (c) pbt: generation {g['generation']} winners {g['winners']} "
                      f"exploited {g['exploited']} against the serial {w['winners']} "
                      f"{w['exploited']}")
                loss_rel = max(loss_rel, _np_rel(np.asarray(g["fitness"]),
                                                 np.asarray(w["fitness"])))
            check(r0["scalars"] == want["scalars"],
                  f"mesh (c) pbt: scalars {r0['scalars']} against {want['scalars']}")
        else:
            check(r0["hyper"] == (key == "hyper"), f"mesh (c) {key}: hyper {r0['hyper']}")
            loss_rel = _np_rel(np.asarray(r0["history"]), np.asarray(want["history"]))
        check(loss_rel <= MESH_LOSS_RTOL,
              f"mesh (c) {key}: losses {loss_rel} off the serial run's (rel)")
        errs, failed = _fleet_params_check(r0["final"], want["final"], noise,
                                           want["rms_grad"], lr_max, want["steps"], key)
        failures += failed
        out[key] = {"wall_s": [r[key]["wall_s"] for r in ranks],
                    "serial_wall_s": want["wall_s"],
                    "launches_per_rank": [r[key]["launches"] for r in ranks],
                    "serial_launches": want["launches"],
                    "comms": r0["comms"], "lanes_per_rank": [r[key].get("lanes")
                                                             for r in ranks],
                    "loss_max_rel_err": loss_rel, "ranks_bitwise": True, **errs}
        if key == "pbt":
            out[key].update(winners=[g["winners"] for g in r0["generations"]],
                            exploited=[g["exploited"] for g in r0["generations"]],
                            scalars=r0["scalars"])
    check(not failures, "mesh (c): lane parameters off the serial runs': "
          + "; ".join(failures))
    return out


def _mesh_rank(rank: int, init: str, q, seed: int, root: str) -> None:
    """One rank of the two sharing the card over gloo: the 2 x 1 and the
    1 x 2 mesh runs (`_mesh_run`), then the fleets of phase (c) on 2 x 1
    and on the hierarchical mesh, sent back through `q`."""
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from factorvae_tpu_torch.config import MeshConfig
        from factorvae_tpu_torch.ops.kernels.attention import attention_bwd, attention_fwd
        from factorvae_tpu_torch.ops.kernels.gru import (
            gru_bwd,
            gru_dwh,
            gru_fwd,
            gru_fwd_residuals,
        )
        from factorvae_tpu_torch.parallel.mesh import make_hierarchical_mesh, make_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
        counters = (gru_fwd, gru_fwd_residuals, gru_bwd, gru_dwh, attention_fwd,
                    attention_bwd)
        cfg, panel = _mesh_setup(seed)
        out = {}
        for sp in (1, 2):
            mesh = make_mesh(MeshConfig(stock_axis=sp))
            out[f"{2 // sp}x{sp}"] = _mesh_run(torch, cfg, panel, mesh, counters)
        out["fleets"] = _mesh_fleet_runs(
            torch, cfg, panel, root, counters, mesh=make_mesh(MeshConfig(stock_axis=1)),
            hier_mesh=make_hierarchical_mesh(MeshConfig(stock_axis=1), num_hosts=2))
        dist.destroy_process_group()
        q.put((rank, "ok", out))
    except BaseException:       # noqa: BLE001 - the parent fails the phase with it
        q.put((rank, "error", traceback.format_exc()))


def _mesh_check(want: dict, got: dict, what: str, lr: float) -> dict:
    """`got` (a mesh run) against `want` (the serial run on the card):
    errors of the first update's gradients and parameters, the losses."""
    g_err = p_err = 0.0
    small = 0
    for name, g in want["first"]["grads"].items():
        tol = GRU_MESH_TOL if "gru" in name else MESH_TOL
        mine = got["first"]["grads"][name]
        check(np.allclose(mine, g, **tol), f"mesh {what}: gradient of {name} off by "
              f"{float(np.max(np.abs(mine - g)))}")
        g_err = max(g_err, float(np.max(np.abs(mine - g))))
        signal = np.abs(g) > tol["atol"]
        small += int((~signal).sum())
        pw, pg = want["first"]["params"][name], got["first"]["params"][name]
        check(np.allclose(pg[signal], pw[signal], **tol),
              f"mesh {what}: {name} after the first update")
        check(bool(np.all(np.abs(pg - pw)[~signal] <= 2 * lr * (1 + 1e-4))),
              f"mesh {what}: {name}'s noise-gradient elements moved more than 2 lr")
        p_err = max(p_err, float(np.max(np.abs(pg - pw)[signal], initial=0.0)))
    loss_rel = float(np.max(np.abs(np.asarray(got["losses"]) - want["losses"])
                            / np.abs(want["losses"])))
    check(loss_rel <= MESH_LOSS_RTOL, f"mesh {what}: losses {got['losses']} against "
          f"serial {want['losses']}")
    return {"grad_max_abs_err": g_err, "param_max_abs_err": p_err,
            "noise_grad_elements": small, "loss_max_rel_err": loss_rel}


def phase_mesh(torch, seed: int, counters, card: str) -> dict:
    """(a) NCCL at world size 1, this process: the 1 x 1 mesh's updates
    bitwise the serial ones; (b) two ranks sharing the card over gloo, the
    2 x 1 and the 1 x 2 meshes, against the serial run on the card; (c) the
    same ranks' fleets (hyper, PBT, hierarchical) against the serial ones
    on the card; (d) `autotune --mesh` in (a)'s group of one."""
    import queue
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.parallel.mesh import make_mesh

    cfg, panel = _mesh_setup(seed)
    serial = _mesh_run(torch, cfg, panel, None, counters)
    rdv = tempfile.TemporaryDirectory(prefix="chip_smoke_rdv_")
    root = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_fleets_")
    serial_fleets = _mesh_fleet_runs(torch, cfg, panel, root.name, counters)
    noise = _first_step_noise(torch, cfg, panel, root.name)

    # (a) NCCL, a world of one
    dist.init_process_group("nccl", init_method=f"file://{rdv.name}/nccl", world_size=1,
                            rank=0)
    try:
        probe = torch.arange(4.0, device="cuda")
        dist.all_reduce(probe)
        check(torch.equal(probe, torch.arange(4.0, device="cuda")),
              "mesh (a): an NCCL all-reduce over one rank changed its tensor")
        one = _mesh_run(torch, cfg, panel, make_mesh(MeshConfig()), counters)
        # (d) the mesh race at world 1: the 1 x 1 mesh against no mesh
        table = os.path.join(root.name, "plan_table.json")
        race_rows, race_launches, race_s, _ = _autotune(
            torch, counters, ["--config", "csi300-k60", "--mesh", "--device", "cuda", "--days",
                              str(MESH_RACE_DAYS), "--reps", "1", "--out", table],
            what="mesh (d)")
    finally:
        dist.destroy_process_group()
    for name, p in serial["params"].items():
        check(np.array_equal(one["params"][name], p), f"mesh (a): 1 x 1 {name} is not "
              "bitwise the serial run's")
    check(one["losses"] == serial["losses"], "mesh (a): 1 x 1 losses differ")
    for name, n in one["launches"].items():
        check(n > 0 or name == "gru_fwd", f"mesh (a): {name} not launched")

    # (b) two gloo ranks on the one card
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(r, f"file://{rdv.name}/gloo", q, seed,
                                                  root.name))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    ranks, errors = {}, []
    try:
        for _ in procs:
            rank, kind, value = q.get(timeout=600)
            if kind == "ok":
                ranks[rank] = value
            else:
                errors.append(f"rank {rank}: {value}")
                break
    except queue.Empty:
        errors.append("the two mesh ranks did not finish within 600 s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    check(not errors, "mesh (b): " + "\n".join(errors))
    ranks_s = time.perf_counter() - t0
    lr = float(cfg.train.lr)
    runs = {"1x1_nccl": {"step_wall_s": one["step_wall_s"], "comms": one["comms"],
                         "launches": one["launches"], "bitwise_serial": True}}
    for key in ("2x1", "1x2"):
        r0, r1 = ranks[0][key], ranks[1][key]
        for name in r0["params"]:
            check(np.array_equal(r0["params"][name], r1["params"][name]),
                  f"mesh {key}: ranks disagree on {name}")
        for r, got in ((0, r0), (1, r1)):
            for name in ("gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_fwd",
                         "attention_bwd"):
                check(got["launches"][name] > 0, f"mesh {key}: rank {r} never launched "
                      f"{name}")
        rows_per_day = 150 if key == "1x2" else 300
        days_local = 2 if key == "1x2" else 1
        check(r0["n_local"] == rows_per_day and
              set(r0["k1_rows"]) == {rows_per_day * days_local},
              f"mesh {key}: K1 saw rows {sorted(set(r0['k1_rows']))}, want "
              f"{rows_per_day * days_local} ({rows_per_day} stocks x {days_local} days)")
        errs = _mesh_check(serial, r0, key, lr)
        runs[key] = {"step_wall_s": r0["step_wall_s"], "comms": r0["comms"],
                     "launches": r0["launches"], "launches_rank1": r1["launches"],
                     "k1_rows_per_launch": r0["k1_rows"][0], "ranks_bitwise": True, **errs}
        if key == "1x2":
            for r, got in ((0, r0), (1, r1)):
                err = np.nanmax(np.abs(got["scores"] - serial["scores"]))
                check(np.allclose(got["scores"], serial["scores"], equal_nan=True,
                                  **MESH_TOL),
                      f"mesh 1x2: rank {r}'s scores off by {err}")
            runs[key]["scores_max_abs_err"] = float(
                np.nanmax(np.abs(r0["scores"] - serial["scores"])))
            runs[key]["score_s"] = r0["score_s"]
    fleets = _mesh_fleet_check(serial_fleets, [ranks[0]["fleets"], ranks[1]["fleets"]], noise,
                               cfg)
    for name, n in race_launches.items():
        check(n > 0, f"mesh (d): the race never launched {name}")
    race = []
    for r in race_rows:
        m = r["measured"]
        per = {k: v["mesh"] for k, v in m.items() if k.startswith("n=")} or \
            {f"n={r['n_min']}": m["mesh"]}
        for width, cands in per.items():
            check(set(cands) == {"none", f"mesh_1x1_dps{r['train']['days_per_step']}"},
                  f"mesh (d): candidates {sorted(cands)} at {width}")
        race.append({"n": [r["n_min"], r["n_max"]], "s_per_day": per,
                     "verdict": r.get("mesh") or "none", "train": r["train"],
                     "source": "mesh race " + r["source"].split("; mesh race ")[-1]})
    rdv.cleanup()
    root.cleanup()
    return {"phase": "mesh", "card": card,
            "note": "two ranks share one card over gloo: these runs hold the mesh "
                    "paths to the serial run, they measure no scaling",
            "serial": {"step_wall_s": serial["step_wall_s"], "launches": serial["launches"],
                       "score_s": serial.get("score_s")},
            "runs": runs, "ranks_wall_s": ranks_s,
            "fleets": fleets, "fleet_tol": {"param_atol": TRAIN_PARAM_ATOL,
                                            "cpu_tol": MESH_FLEET_TOL,
                                            "noise_grad_at_most": MESH_FLEET_NOISE},
            "race": {"rows": race, "wall_s": race_s, "launches": race_launches},
            "launches": runs["1x2"]["launches"]}


WIDE_HIDDEN = (128, 256)
WIDE_ODD_H = 200            # the wide attention kernels' uneven slices (52, 52, 52, 44)
WIDE_DAYS = 60              # 30 train + 10 validation + 20 scored days
WIDE_GRID_HIDDEN = (64, 128, 256)
WIDE_GRID_LR = (1e-4, 3e-4)


def _wide_kernels(torch, g, h: int) -> dict:
    """Each kernel at hidden size h through the K phases' checks (flagship
    shapes; K1 and the walk also at T = 60, K3's case; K4 over a 32-day
    chunk and K5 over 8 days, each with an all-masked day and NaN, +inf and
    -inf days), then the kernels' times beside the plain versions',
    cuDNN's nn.GRU forward and backward at the same H, and the bounds."""
    k1_in = {label: _gru_inputs(torch, g, n, t, h)
             for label, (n, t) in (("flagship", (32 * 304, 20)), ("flagship_day", (304, 20)),
                                   ("T60", (304, 60)))}
    k1 = {label: _k1_case(torch, args, f"wide K1 H={h} {label}")
          for label, args in k1_in.items()}
    k2 = {label: _k2_case(torch, _gru_bwd_inputs(torch, g, 304, t, h),
                          f"wide K2 H={h} {label}")
          for label, t in (("flagship_day", 20), ("T60", 60))}
    walk_checks = _wide_walk_checks(torch, g, h)
    k4 = _k4_checks(torch, g, h, f"wide K4 H={h}")
    k5, _ = _k5_case(torch, g, 8, 304, 96, h, 300, f"wide K5 H={h} flagship_8_days")
    attention_checks = _wide_attention_checks(torch, g, h, lanes=h == max(WIDE_HIDDEN))
    worst = {"K1": max(max(c["max_abs_err"], *c["residual_errors"].values())
                       for c in k1.values()),
             "K2": max(v for e in k2.values() for key, v in e.items()
                       if not key.startswith("dwh_")),
             "dWh": max(v for e in k2.values() for key, v in e.items()
                        if key.startswith("dwh_")),
             "K4": max(*k4["errors"].values(), *(e for key, e in
                                                  attention_checks["errors"].items()
                                                  if key.startswith("K4"))),
             "K5": max(*k5["errors"].values(), *(e for key, e in
                                                 attention_checks["errors"].items()
                                                 if key.startswith("K5")))}

    day = _k4_inputs(torch, g, 1, 304, 96, h, 300)
    latent, mask, weights = k4["inputs"]
    k5_day = (*day, torch.randn(1, 96, h, device="cuda", generator=g) * 0.1,
              (torch.rand(1, 96, 304, device="cuda", generator=g) > 0.1).float() / 0.9)
    worst["K2"] = max(worst["K2"], walk_checks["max_abs_err"])
    return {"errors": {"K1": k1, "K2": k2, "K4": k4["errors"], "K5": k5["errors"]},
            "walk_checks": walk_checks, "attention_checks": attention_checks,
            "max_abs_err": worst,
            "exact_path_days": {"K4": k4["exact_path_days"], "K5": k5["exact_path_days"]},
            "timing": {"K1": {label: _k1_timing(torch, k1_in[label], f"H={h} {label}")
                              for label in ("flagship", "flagship_day")},
                       "K2": _k2_timing(torch, g, 304, 20, h),
                       "K3_T60": _k2_timing(torch, g, 304, 60, h),
                       "K4": {"flagship": _k4_timing(torch, latent, mask, weights),
                              "flagship_day": _k4_timing(torch, day[0], day[1], day[2:])},
                       "K5": {"flagship_day": _k5_timing(torch, *k5_day)}}}


def _wide_attention_checks(torch, g, h: int, lanes: bool) -> dict:
    """K4 and K5 above H = 64 beside `_k4_checks`' 32-day chunk and
    `_k5_case`'s 8 poisoned days: K4 at one day and at 8 days, K5 at one day
    and at a 32-day chunk, each without and with a keep-mask against its
    plain version (K4_TOL, K5_TOL), bitwise on a repeat and at every
    heads-per-cluster size (the rule's pick among them); with `lanes`, two
    lanes of 2 days in one launch, each bitwise its one-lane launch, forward
    and backward. Returns the errors and the sizes compared."""
    from factorvae_tpu_torch.ops.kernels import attention as m

    names = ("dlatent", "dquery", "dWk", "dbk", "dWv", "dbv")
    n, k, n_real = 304, 96, 300
    sizes = [x for x in m.GROUPS if x * n <= m.MAX_GROUP_ROWS]
    errs, groups = {}, {}
    for label, (kind, b) in {"K4_day": ("fwd", 1), "K4_8_days": ("fwd", 8),
                             "K5_day": ("bwd", 1), "K5_32_days": ("bwd", 32)}.items():
        latent, mask, *w = _k4_inputs(torch, g, b, n, k, h, n_real)
        keep = (torch.rand(b, k, n, device="cuda", generator=g) > 0.1).float() / 0.9
        dctx = torch.randn(b, k, h, device="cuda", generator=g) * 0.1
        groups[label] = m._group(latent, k)
        for kp_label, kp in (("", None), ("keep_", keep)):
            if kind == "fwd":
                got = m.attention_fwd(latent, mask, *w, keep=kp)
                want = m.attention_fwd_plain(latent, mask, *w, keep=kp)
                errs[f"{label}_{kp_label}ctx"] = float((got - want).abs().max())
                runs = [m.attention_fwd(latent, mask, *w, keep=kp)]
                runs += [m._fwd_launch(latent, mask, *w, kp, x)[0] for x in sizes]
                same = all(torch.equal(r, got) for r in runs)
            else:
                got = m.attention_bwd(latent, mask, *w, dctx, keep=kp)
                want = m.attention_bwd_plain(latent, mask, *w, dctx, keep=kp)
                for name, e in _grad_errors(got, want, names).items():
                    errs[f"{label}_{kp_label}{name}"] = e
                runs = [m.attention_bwd(latent, mask, *w, dctx, keep=kp)]
                runs += [m._bwd_launch(latent, mask, *w, dctx, kp, x)[0] for x in sizes]
                same = all(all(torch.equal(a, c) for a, c in zip(r, got)) for r in runs)
            check(same, f"wide attention H={h} {label} {kp_label or 'no keep'}: a repeat or "
                        f"another heads-per-cluster size is not bitwise the rule's launch")
        torch.cuda.synchronize()
    out = {"errors": errs, "heads_per_cta": groups, "sizes_bitwise": sizes,
           "max_abs_err": max(errs.values())}
    check(max(e for key, e in errs.items() if key.startswith("K4")) <= K4_TOL,
          f"wide K4 H={h}: errors {errs} > {K4_TOL}")
    check(max(e for key, e in errs.items() if key.startswith("K5")) <= K5_TOL,
          f"wide K5 H={h}: errors {errs} > {K5_TOL}")
    if lanes:
        two = [_k4_inputs(torch, g, 2, n, k, h, n_real) for _ in range(2)]
        lat2, mask2, *w2 = (torch.stack(a) for a in zip(*two))
        keep2 = (torch.rand(2, 2, k, n, device="cuda", generator=g) > 0.1).float() / 0.9
        dctx2 = torch.randn(2, 2, k, h, device="cuda", generator=g) * 0.1
        ctx2, _, _ = m._fwd_launch(lat2, mask2, *w2, keep2, m._group(lat2, k))
        grads2, _, _ = m._bwd_launch(lat2, mask2, *w2, dctx2, keep2, m._group(lat2, k))
        for i in range(2):
            one = (lat2[i], mask2[i], *(x[i] for x in w2))
            ctx1 = m._fwd_launch(*one, keep2[i], m._group(lat2[i], k))[0]
            grads1 = m._bwd_launch(*one, dctx2[i], keep2[i], m._group(lat2[i], k))[0]
            check(torch.equal(ctx1, ctx2[i]) and all(torch.equal(a, c[i])
                                                     for a, c in zip(grads1, grads2)),
                  f"wide attention H={h}: lane {i} differs from its one-lane launch")
        out["lanes"] = {"lanes": 2, "days": 2, "heads_per_cta": m._group(lat2, k),
                        "bitwise_one_lane": True}
    return out


def _wide_walk_checks(torch, g, h: int) -> dict:
    """The walk above H = 64 at one training day and at T = 60, launched at
    every shape it takes (`walk_shapes`: each tile size at each cluster)
    against its plain version: within K2_TOL, and at the rule's cluster
    every tile bitwise the rule's pick (a row's result does not depend on
    its tile or on the persistent clusters that ran it); two lanes each
    bitwise its one-lane launch; a NaN in Wh, in dh or in a residual comes
    out where the plain version's does (the walk, and dWh of a NaN in
    hseq). Returns the errors and the shapes."""
    from factorvae_tpu_torch.ops.kernels import gru as m

    out, worst = {}, 0.0

    def err_of(got, want):
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    for label, t in (("flagship_day", 20), ("T60", 60)):
        xi, wh, bh, dh = _gru_bwd_inputs(torch, g, 304, t, h)
        _, hseq, gseq = m.gru_fwd_residuals(xi, wh, bh)
        want = m.gru_walk_plain(xi, wh, hseq, gseq, dh)
        picked = m._walk_shape(xi)
        ref = m._walk_launch(xi, wh, hseq, gseq, dh, picked)
        errs = {}
        for shape in m.walk_shapes(h):
            got = m._walk_launch(xi, wh, hseq, gseq, dh, shape)
            errs["x".join(map(str, shape))] = err_of(got, want)
            if shape[1] == picked[1]:
                check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                      f"wide walk H={h} {label}: tile {shape} differs from the rule's {picked}")
        check(max(errs.values()) <= K2_TOL, f"wide walk H={h} {label}: errors {errs}")
        worst = max(worst, *errs.values())
        out[label] = {"launch_shape": list(picked), "errors": errs}

    # two lanes in one launch, each bitwise its one-lane launch
    lanes = [_gru_bwd_inputs(torch, g, 304, 20, h) for _ in range(2)]
    xi2, wh2, bh2, dh2 = (torch.stack(a) for a in zip(*lanes))
    _, hseq2, gseq2 = m.gru_fwd_residuals(xi2, wh2, bh2)
    two = m._walk_launch(xi2, wh2, hseq2, gseq2, dh2, m._walk_shape(xi2))
    for i in range(2):
        one = m._walk_launch(xi2[i], wh2[i], hseq2[i], gseq2[i], dh2[i],
                             m._walk_shape(xi2[i]))
        check(all(torch.equal(a[i], b) for a, b in zip(two, one)),
              f"wide walk H={h}: lane {i} differs from its one-lane launch")
    out["lanes"] = {"launch_shape": list(m._walk_shape(xi2)), "bitwise_one_lane": True}

    # NaN in Wh, in dh and in a residual: the plain version's NaNs
    xi, wh, bh, dh = _gru_bwd_inputs(torch, g, 304, 20, h)
    _, hseq, gseq = m.gru_fwd_residuals(xi, wh, bh)
    nan = torch.zeros((), device="cuda") * torch.full((), float("inf"), device="cuda")
    cases = {"wh": (wh.clone(), dh, gseq), "dh": (wh, dh.clone(), gseq),
             "gseq": (wh, dh, gseq.clone())}
    cases["wh"][0][3, 5] = nan
    cases["dh"][1][7, 2] = nan
    cases["gseq"][2][9, 13, 4] = nan
    nan_cells = {}
    for key, (w_, d_, g_) in cases.items():
        got = m._walk_launch(xi, w_, hseq, g_, d_, m._walk_shape(xi))
        want = m.gru_walk_plain(xi, w_, hseq, g_, d_)
        check(all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(got, want)),
              f"wide walk H={h}: a NaN in {key} is not where the plain version's is")
        fin = err_of([a.nan_to_num() for a in got], [b.nan_to_num() for b in want])
        check(fin <= K2_TOL, f"wide walk H={h}: NaN in {key}, finite values off by {fin}")
        nan_cells[key] = int(got[0].isnan().sum())
    bad_h = hseq.clone()
    bad_h[11, 6, 9] = nan
    dxi, dgn = m.gru_walk_plain(xi, wh, hseq, gseq, dh)
    got, want = m.gru_dwh(bad_h, dxi, dgn), m.gru_dwh_plain(bad_h, dxi, dgn)
    check(all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(got, want)),
          f"wide dWh H={h}: a NaN in hseq is not where the plain version's is")
    out["nan"] = {"dxi_nan_cells": nan_cells, "dwh_nan_rows": int(
        got[0].isnan().any(dim=1).sum())}
    out["max_abs_err"] = worst
    return out


# The flagship's widths (the CLI's reference defaults) and panel
WIDE_WIDTHS = {"num_latent": 158, "num_factor": 96, "num_portfolio": 128, "seq_len": 20,
               "stocks": 300}


def _wide_paths(torch, seed: int, counters, root: str) -> dict:
    """The wide phase's entry points at each hidden size of WIDE_HIDDEN: (a)
    the experiment CLI trains one epoch and scores; (b) the daemon admits
    its best weights and answers a day and a 34-day range, held against the
    CPU; then (c) a width grid over WIDE_GRID_HIDDEN x WIDE_GRID_LR. Every
    launch counter is set to 0 just before each and read just after."""
    from factorvae_tpu_torch import cli
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import panel_to_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.eval.sweep import grid_sweep
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon
    from factorvae_tpu_torch.serve.registry import ModelRegistry

    stocks, t = WIDE_WIDTHS["stocks"], WIDE_WIDTHS["seq_len"]
    panel = synthetic_panel_dense(WIDE_DAYS, stocks, WIDE_WIDTHS["num_latent"], seed=seed)
    d = [str(x) for x in panel.dates]
    pkl = os.path.join(root, "panel.pkl")
    panel_to_frame(panel).to_pickle(pkl)
    dataset = PanelDataset(panel, seq_len=t, device="cuda")
    cpu_ds = PanelDataset(panel, seq_len=t, device="cpu")
    train_names = ("gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_bwd")
    steps, val_batches, chunks = 30, 10, 1
    dates = ["--start_time", d[0], "--fit_end_time", d[29], "--val_start_time", d[30],
             "--val_end_time", d[39]]
    model_flags = [f"--{k}={v}" for k, v in WIDE_WIDTHS.items() if k != "stocks"]
    out = {}
    for h in WIDE_HIDDEN:
        argv = ["--dataset", pkl, *model_flags, "--hidden_size", str(h), "--num_epochs", "1",
                "--seed", str(seed), "--run_name", f"wide{h}", *dates,
                "--score_start", d[40], "--score_end", d[WIDE_DAYS - 1],
                "--deterministic_scores", "--device", "cuda",
                "--save_dir", f"{root}/{h}/models", "--score_dir", f"{root}/{h}/scores",
                "--metrics_jsonl", f"{root}/{h}/run.jsonl"]
        run = _cli_drive(torch, cli, counters, argv)
        la = run["launches"]
        (epoch,) = _of(run, "epoch")
        (scores,) = _of(run, "scores")
        check(all(la[n] == steps for n in train_names)
              and la["gru_fwd"] == val_batches + chunks
              and la["attention_fwd"] == la["gru_fwd"] + la["gru_fwd_residuals"],
              f"wide cli H={h}: {steps} steps, {val_batches} validation batches, "
              f"{chunks} scoring chunk but launches {la}")
        check(np.isfinite(epoch["train_loss"]) and np.isfinite(epoch["val_loss"])
              and np.isfinite(scores["rank_ic"]), f"wide cli H={h}: {epoch}, {scores}")
        head, csv_scores = _csv_scores(scores["path"])
        valid_rows = int(panel.valid[40:WIDE_DAYS].sum())
        check(head == ["datetime", "instrument", "score", "LABEL0"]
              and len(csv_scores) == valid_rows and bool(np.isfinite(csv_scores).all()),
              f"wide cli H={h}: CSV {head}, {len(csv_scores)} rows for {valid_rows}")

        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        best = os.path.join(cfg.train.save_dir, cfg.checkpoint_name())
        registry = ModelRegistry(device="cuda")
        registry.admit(best, cfg, alias=f"wide{h}")
        daemon = ScoringDaemon(registry, dataset)
        day_req = {"id": 1, "model": f"wide{h}", "day": d[45]}
        range_req = {"id": 2, "model": f"wide{h}", "start": d[19], "end": d[52]}
        daemon.handle_batch([day_req])      # warm-up
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        responses = daemon.handle_batch([day_req, range_req])
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) * 1e3
        ld = {c.__name__: c.launches for c in counters}
        check(all(r["ok"] for r in responses), f"wide daemon H={h}: {responses}")
        check(ld["gru_fwd"] > 0 and ld["attention_fwd"] > 0
              and all(ld[n] == 0 for n in train_names), f"wide daemon H={h}: launches {ld}")
        ranged = np.asarray([r["scores"] for r in responses[1]["results"]], np.float32)
        day_scores = np.asarray(responses[0]["results"][0]["scores"], np.float32)
        check(ranged.shape == (34, stocks) and bool(np.isfinite(ranged).all()),
              f"wide daemon H={h}: range scores {ranged.shape}")
        # the range's first two days and the day on the CPU, same weights
        cpu_model = load_model(cfg, checkpoint_path=best, device="cpu")
        want = predict_panel(cpu_model, cfg, cpu_ds, np.concatenate(
            [cpu_ds.split_days(d[19], d[20]), cpu_ds.split_days(d[45], d[45])]),
                             stochastic=False)[:, :stocks]
        want_two, want_day = want[:2], want[2]
        check(day_scores.shape == want_day.shape, f"wide daemon H={h}: day scores "
              f"{day_scores.shape}, not {want_day.shape} (a dense panel)")
        err = max(float(np.abs(day_scores - want_day).max()),
                  float(np.abs(ranged[:2] - want_two).max()))
        check(err <= SLICE_TOL, f"wide daemon H={h}: card vs CPU {err} > {SLICE_TOL}")
        check(all(la[n] > 0 for n in ("gru_fwd", "gru_fwd_residuals", "gru_bwd", "gru_dwh",
                                      "attention_fwd", "attention_bwd")),
              f"wide H={h}: a kernel was not launched on the main path: {la}")
        out[str(h)] = {"cli": {"launches": la, "wall_s": run["wall_s"], "epoch": epoch,
                               "rank_ic": scores["rank_ic"], "csv_rows": len(csv_scores)},
                       "daemon": {"launches": ld, "tick_ms": tick_ms,
                                  "cuda_vs_cpu_max_abs_err": err,
                                  "latency_ms": [r.get("latency_ms") for r in responses]}}

    # (c) the width grid: three shape buckets, each a 2-lane hyper-fleet on
    # the lane-batched kernels
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [*model_flags, "--num_epochs", "1", "--seed", str(seed), *dates,
         "--save_dir", f"{root}/grid"]))
    points = [{"hidden_size": h, "lr": lr} for h in WIDE_GRID_HIDDEN for lr in WIDE_GRID_LR]
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    frame = grid_sweep(cfg, dataset, points, score_start=d[40], score_end=d[WIDE_DAYS - 1],
                       device="cuda")
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    lg = {c.__name__: c.launches for c in counters}
    check(len(frame) == len(points) and bool(np.isfinite(frame["rank_ic"]).all())
          and bool(np.isfinite(frame["best_val"]).all()), f"wide grid: {frame.to_dict()}")
    check(all(lg[n] == len(WIDE_GRID_HIDDEN) * steps for n in train_names),
          f"wide grid: {len(WIDE_GRID_HIDDEN)} buckets of {steps} fleet steps but launches "
          f"{lg}")
    out["grid"] = {"points": len(points), "buckets": len(WIDE_GRID_HIDDEN),
                   "hidden": list(WIDE_GRID_HIDDEN), "lr": list(WIDE_GRID_LR), "launches": lg,
                   "wall_s": grid_s, "best_label": frame.attrs["summary"]["best_label"],
                   "rank_ic": {str(k): float(v) for k, v in frame["rank_ic"].items()}}
    return out


def phase_wide(torch, seed: int, counters, card: str) -> dict:
    import tempfile

    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    kernels = {str(h): _wide_kernels(torch, g, h) for h in WIDE_HIDDEN}
    odd = WIDE_ODD_H
    k4_odd = _k4_checks(torch, g, odd, f"wide K4 H={odd}")
    k5_odd, _ = _k5_case(torch, g, 8, 304, 96, odd, 300, f"wide K5 H={odd} flagship_8_days")
    odd_attention = {"K4_chunk": {key: k4_odd[key] for key in ("errors", "exact_path_days",
                                                               "group")},
                     "K5_8_days": k5_odd,
                     **_wide_attention_checks(torch, g, odd, lanes=False)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_") as root:
        paths = _wide_paths(torch, seed, counters, root)
    grid = paths.pop("grid")
    return {"phase": "wide", "card": card, "hidden": list(WIDE_HIDDEN),
            "config": "flagship C158/T20/K96/M128, 300 stocks padded to 304, f32, at "
                      "hidden_size 128 and 256",
            "kernels": kernels, f"attention_H{odd}": odd_attention, "paths": paths,
            "grid": grid}


def _collect_fleet_check(router_url: str) -> dict:
    """The pool phase's fleet through `obs/collect.collect_fleet`: the
    router's and both workers' streams merged on the router's clock; every
    worker span of a routed request inside its router_forward span, up to
    half the clock probe's round trip."""
    from factorvae_tpu_torch.obs.collect import collect_fleet, estimate_offsets

    t0 = time.perf_counter()
    merged, since = collect_fleet(router_url, timeout=60)
    wall_s = time.perf_counter() - t0
    procs = sorted({r["proc"] for r in merged})
    check(procs == ["router", "w0", "w1"], f"pool (e): merged processes {procs}")
    check(all(r.get("aligned", True) for r in merged), "pool (e): a worker without a probe")
    offsets = estimate_offsets([r for r in merged if r["proc"] == "router"])
    legs: dict = {}
    for r in merged:
        if (r.get("event") == "span" and r["proc"] == "router"
                and r["name"] == "router_forward" and r.get("trace")):
            legs.setdefault(r["trace"], []).append(r)
    inside, outside, worst = 0, [], 0.0
    for r in merged:
        if r.get("event") != "span" or r["proc"] == "router" or r.get("trace") not in legs:
            continue
        slack = offsets[r["proc"]]["rtt"] / 2.0
        mine = [f for f in legs[r["trace"]] if f.get("worker") == r["proc"]]
        gap = min((max(f["t0"] - r["t0"], r["t1"] - f["t1"], 0.0) for f in mine),
                  default=float("inf"))
        worst = max(worst, gap)
        if gap <= slack:
            inside += 1
        else:
            outside.append((r["name"], r["trace"], gap, slack))
    check(inside > 0 and not outside,
          f"pool (e): worker spans outside their router spans {outside[:5]}")
    return {"records": len(merged), "by_proc": {p: sum(r["proc"] == p for r in merged)
                                                 for p in procs},
            "since": since, "wall_s": wall_s,
            "offsets": {w: {"offset_s": o["offset"], "rtt_ms": o["rtt"] * 1e3,
                            "probes": o["probes"]} for w, o in offsets.items()},
            "routed_worker_spans_inside": inside, "worst_gap_s": worst}


KERNEL_SOURCES = {
    "gru_fwd": ("factorvae_tpu_torch/csrc/gru_fwd.cu", "factorvae_tpu/ops/pallas/gru.py:417"),
    "gru_fwd_residuals": ("factorvae_tpu_torch/csrc/gru_fwd.cu",
                          "factorvae_tpu/ops/pallas/gru.py:417 (the forward of gru_scan's "
                          "VJP)"),
    "gru_bwd": ("factorvae_tpu_torch/csrc/gru_bwd.cu",
                "factorvae_tpu/ops/pallas/gru.py:480 (T <= 24) and "
                "factorvae_tpu/ops/pallas/gru.py:533 (T > 24)"),
    "gru_dwh": ("factorvae_tpu_torch/csrc/gru_bwd.cu",
                "factorvae_tpu/ops/pallas/gru.py:480 and :533 (their dWh and db)"),
    "attention_fwd": ("factorvae_tpu_torch/csrc/attention_fwd.cu",
                      "factorvae_tpu/ops/pallas/attention.py:104"),
    "attention_bwd": ("factorvae_tpu_torch/csrc/attention_bwd.cu",
                      "factorvae_tpu/ops/pallas/attention_grad.py:112"),
}


def _wide_rows(wide: dict) -> list:
    """The kernels line's rows of the wide phase: each kernel at each wide H,
    its launches those of that H's CLI run (train and score), its daemon
    tick's and the width grid's (every bucket) beside them."""
    rows = []
    for h in wide["hidden"]:
        k = wide["kernels"][str(h)]
        t, err = k["timing"], k["max_abs_err"]
        path = wide["paths"][str(h)]
        day = t["K1"]["flagship_day"]
        for name, e, tol, tm in (
                ("gru_fwd", err["K1"], K1_TOL, t["K1"]["flagship"]),
                ("gru_fwd_residuals", err["K1"], K1_TOL,
                 {**day["residuals"], "library_ms": day["library_ms"],
                  "library_graph_ms": day["library_graph_ms"]}),
                ("gru_bwd", err["K2"], K2_TOL, t["K2"]),
                ("gru_dwh", err["dWh"], K2_TOL, t["K2"]["dwh"]),
                ("attention_fwd", err["K4"], K4_TOL, t["K4"]["flagship"]),
                ("attention_bwd", err["K5"], K5_TOL, t["K5"]["flagship_day"])):
            src, replaces = KERNEL_SOURCES[name]
            row = {"name": f"{name} (H={h})", "route": "cuda", "source": src,
                   "replaces": replaces, "hidden_size": h,
                   "launches": path["cli"]["launches"][name],
                   "launches_daemon": path["daemon"]["launches"][name],
                   "launches_grid": wide["grid"]["launches"][name],
                   "max_abs_err": e, "tolerance": tol, "ms": tm["ms"],
                   "graph_ms": tm.get("graph_ms"), "plain_ms": tm["plain_ms"],
                   "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                   "library_ms": tm["library_ms"],
                   "library_graph_ms": tm.get("library_graph_ms")}
            if name == "gru_bwd":
                t60 = t["K3_T60"]
                row["t60"] = {key: t60[key] for key in (
                    "shape", "ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
                    "bound_ms", "bound_by")}
                row["pair"] = {key: tm["pair"][key] for key in (
                    "graph_ms", "library_graph_ms", "bound_ms", "bound_by")}
                row["walk"] = tm["walk"]
                row["walk_t60"] = t60["walk"]
                row["walk_checks"] = k["walk_checks"]
            if name == "gru_dwh":
                row["t60"] = {key: t["K3_T60"]["dwh"][key] for key in (
                    "graph_ms", "library_graph_ms", "bound_ms", "bound_by")}
            rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write every phase here (JSON)")
    p.add_argument("--only", default=None,
                   help="comma-separated phases to run after device and build "
                        "(e.g. K1,K2); prints no kernels line and no result")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA "
              "GPU (nothing was run)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from factorvae_tpu_torch.ops.kernels.attention import attention_bwd, attention_fwd
    from factorvae_tpu_torch.ops.kernels.gru import (
        gru_bwd,
        gru_dwh,
        gru_fwd,
        gru_fwd_residuals,
    )

    # Every phase pins the knobs it checks: the checkout's measured plan rows
    # (PLAN_TABLE_TORCH.json) must not move a daemon's `--precision plan` or
    # an admission's rung under them; the plan phase makes its own tables.
    import tempfile

    from factorvae_tpu_torch.plan import PLAN_TABLE_ENV

    no_rows = tempfile.TemporaryDirectory(prefix="chip_smoke_no_plan_")
    os.environ[PLAN_TABLE_ENV] = os.path.join(no_rows.name, "no_rows.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)

    counters = (gru_fwd, gru_fwd_residuals, gru_bwd, gru_dwh, attention_fwd, attention_bwd)
    steps = {
        "device": lambda: phase_device(torch), "build": phase_build,
        "K1": lambda: phase_k1(torch, args.seed), "K4": lambda: phase_k4(torch, args.seed),
        "slice": lambda: phase_slice(torch, args.seed, (gru_fwd, attention_fwd),
                                     (gru_fwd_residuals, gru_bwd, gru_dwh, attention_bwd)),
        "K2": lambda: phase_k2(torch, args.seed), "K5": lambda: phase_k5(torch, args.seed),
        "train": lambda: phase_train(torch, args.seed, counters),
        "precision": lambda: phase_precision(torch, args.seed, counters),
        "cli": lambda: phase_cli(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "fleet": lambda: phase_fleet(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "stream": lambda: phase_stream(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "serve": lambda: phase_serve(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "pool": lambda: phase_pool(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "stacked": lambda: phase_stacked(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "wf": lambda: phase_wf(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "obs": lambda: phase_obs(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "remat": lambda: phase_remat(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "factors": lambda: phase_factors(torch, args.seed, counters,
                                         phases[0]["nvidia_smi"]),
        "plan": lambda: phase_plan(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "mesh": lambda: phase_mesh(torch, args.seed, counters, phases[0]["nvidia_smi"]),
        "wide": lambda: phase_wide(torch, args.seed, counters, phases[0]["nvidia_smi"])}
    names = list(steps)
    if args.only:
        names = ["device", "build"] + [n for n in args.only.split(",") if n in steps]
    phases = []
    for name in names:
        t0 = time.perf_counter()
        out = steps[name]()
        out["wall_s"] = time.perf_counter() - t0
        phases.append(out)
        emit(out)
    if args.only:
        _write(args.out, {"phases": phases})
        return 0

    by = {ph["phase"]: ph for ph in phases}
    launches = by["train"]["launches"]
    fk = by["fleet"]["kernels"]
    fleet_timing = {**fk["gru_flagship_day"]["timing"], **fk["attention_flagship_day"]["timing"]}
    rows = []
    for name, ph in (("gru_fwd", by["K1"]), ("gru_fwd_residuals", by["K1"]["residuals_row"]),
                     ("gru_bwd", by["K2"]), ("gru_dwh", by["K2"]["dwh_row"]),
                     ("attention_fwd", by["K4"]), ("attention_bwd", by["K5"])):
        src, replaces = KERNEL_SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "launches_serving": by["slice"]["launches"].get(name, 0),
                     "launches_cli": by["cli"]["launches"]["a_train_score"][name],
                     "launches_mixed": by["precision"]["mixed_epoch"]["launches"][name],
                     "launches_fleet": by["fleet"]["launches"][name],
                     "launches_stream": by["stream"]["train"]["launches"][name],
                     "launches_serve": by["serve"]["launches"][name],
                     "launches_artifact": by["pool"]["launches_artifact"][name],
                     "launches_pool": by["pool"]["launches_pool"][name],
                     "launches_stacked": by["stacked"]["launches"][name],
                     "launches_wf": by["wf"]["launches"][name],
                     "launches_obs": by["obs"]["launches"][name],
                     "launches_remat": by["remat"]["launches"][name],
                     "launches_factors": by["factors"]["launches"][name],
                     "launches_plan": by["plan"]["launches"][name],
                     "launches_mesh": by["mesh"]["launches"][name],
                     "launches_mesh_fleets": {
                         k: [r[name] for r in by["mesh"]["fleets"][k]["launches_per_rank"]]
                         for k in ("hyper", "pbt", "hier")},
                     "profiler_us_per_launch": by["obs"]["profiler_us_per_launch"][name],
                     **{f"fleet_{k}": v for k, v in fleet_timing[name].items()},
                     "max_abs_err": ph["max_abs_err"],
                     "tolerance": ph["tolerance"],
                     "ms": ph["ms"], "graph_ms": ph.get("graph_ms"),
                     "plain_ms": ph["plain_ms"], "bound_ms": ph["bound_ms"],
                     "bound_by": ph["bound_by"], "library_ms": ph["library_ms"],
                     "library_graph_ms": ph.get("library_graph_ms")})
    rows += _wide_rows(by["wide"])
    kernels = {"kernels": rows}
    emit(kernels)
    _write(args.out, {"phases": phases, **kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _write(path, obj) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=1)


if __name__ == "__main__":
    sys.exit(main())
