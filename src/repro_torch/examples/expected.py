"""The JAX twins' lines: the yardstick of the port's examples.

``LINES`` holds what each script of the JAX package's ``examples/``
prints, ``GNN_STEP_LOSSES`` the loss of every training step of
``examples/triangle_features_gnn.py`` (its degree-only run, then its run
with the triangle feature) and ``TRAIN_LM_STEP_LOSSES`` that of
``examples/train_lm.py``. All were recorded once, on a CPU, with

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/record_example_lines.py

which rewrites everything below the ``recorded`` marker. ``check``
holds a port example's printed text and returned numbers to them: the
survey examples line for line, exactly. The GNN example's training is
chaotic: its loss spikes (2.1, 2.8, 0.9, 2.5, ... in the twin's own
run), and a change far below what any test could see grows through the
spikes. The twin itself, its initial weights moved by 1e-6, moves its final
loss by 6e-4 to 0.21 (six trainings) and passes ``LOSS_TOL`` from its
own unmoved losses at step 10–24 (``tools/gnn_chaos_witness.py``). The port, from
weights within 7.2e-7 of the twin's, passes it at step 29–31 on the CPU
and 25–33 on an H100, where one run came within 4e-6 of it at step 16
(a spike of the twin's, 0.454 → 0.732). So no second arithmetic
reproduces the twin's final loss to 2e-3, and the GNN example is held
line for line on its survey line, in format on the rest, to the twin's
loss at each of the first ``TRACE_STEPS`` steps within ``LOSS_TOL``
(the steps before that spike), and to what the example shows: finite
losses that fall (:func:`losses_fall`) and a positive triangle-feature
gain. The LM example (:data:`TRAIN_LM`) is held line for line with its
timings masked, every step's loss within ``TRAIN_LM_LOSS_TOL`` of the
twin's, and falling (:func:`check_train_lm`).
"""
from __future__ import annotations

import math
import re
import statistics

GNN = "triangle_features_gnn"
TRACE_STEPS = 16      # training steps held to the twin's losses
LOSS_TOL = 2e-3       # absolute, in nats
FALL_STEPS = 10       # the last steps whose median loss must lie below the first
TRAIN_LM = "train_lm"
# every step's loss of the LM example, absolute, in nats: 200 AdamW steps
# of internlm2's SMOKE model in float32 (CPU: within 2.4e-6 of the twin's)
TRAIN_LM_LOSS_TOL = 1e-3
PRINTED_LOSS_ULP = 1e-4   # a loss printed to four decimals
_NUMBER = re.compile(r"[-+]?\d+(\.\d+)?")


def losses_fall(losses) -> bool:
    """Training lowered the loss: the median of the last ``FALL_STEPS``
    steps' losses lies below the first step's (a single step's loss
    spikes, on the twin's run too)."""
    return statistics.median(losses[-FALL_STEPS:]) < losses[0]


def first_step_past(losses, trace, tol: float = LOSS_TOL):
    """The first step (0-based) at which ``losses`` differ from ``trace``
    by more than ``tol``; ``None`` if no step does."""
    return next((i for i, (a, b) in enumerate(zip(losses, trace))
                 if not abs(a - b) <= tol), None)


def first_steps_past(numbers: dict) -> list:
    """:func:`first_step_past` of a port GNN run's two trainings against
    the twin's recorded losses."""
    return [first_step_past(numbers[r]["losses"], trace)
            for r, trace in zip(("base", "tri"), GNN_STEP_LOSSES)]


def _masked(line: str) -> str:
    return _NUMBER.sub("#", line)


def gnn_drift(numbers: dict) -> dict:
    """The port's final losses and accuracies beside the twin's."""
    pairs = re.findall(r"loss ([\d.]+), accuracy ([\d.]+)", LINES[GNN])
    want = [float(x) for pair in pairs for x in pair]
    got = [numbers[r][k] for r in ("base", "tri") for k in ("loss", "accuracy")]
    keys = ("base_loss", "base_accuracy", "tri_loss", "tri_accuracy")
    return {k: dict(twin=w, port=g, diff=g - w)
            for k, w, g in zip(keys, want, got)}


def _train_lines(text: str) -> list[str]:
    """The LM example's lines less the straggler watchdog's, which flag
    one host's hiccups."""
    return [ln for ln in text.splitlines() if not ln.startswith("[straggler]")]


def check_train_lm(printed: str, numbers: dict, want_text: str,
                   want_losses) -> list[str]:
    """What differs between an LM training run (its printed lines and
    ``numbers["losses"]``) and the twin's (``want_text``,
    ``want_losses``): the first line exactly; the rest with their numbers
    and spacing masked, the printed losses within ``TRAIN_LM_LOSS_TOL``
    and the four-decimal rounding; every step's loss within
    ``TRAIN_LM_LOSS_TOL``, finite, and the last tenth's mean below the
    first's."""
    name = TRAIN_LM
    want, got = _train_lines(want_text), _train_lines(printed)
    errs = []
    if len(got) != len(want):
        errs.append(f"{name}: {len(got)} lines printed, the twin's {len(want)}")
    if got[:1] != want[:1]:
        errs.append(f"{name} first line: {got[:1]} != {want[:1]}")
    loss = re.compile(r"loss ([\d.]+)(?: → ([\d.]+))?")
    for i, (g, w) in enumerate(zip(got, want)):
        if " ".join(_masked(g).split()) != " ".join(_masked(w).split()):
            errs.append(f"{name} line {i} format: {g!r} vs {w!r}")
        mg, mw = loss.search(g), loss.search(w)
        if mg and mw:
            pairs = [(float(a), float(b)) for a, b in zip(mg.groups(), mw.groups())
                     if a is not None and b is not None]
            if any(not abs(a - b) <= TRAIN_LM_LOSS_TOL + PRINTED_LOSS_ULP
                   for a, b in pairs):
                errs.append(f"{name} line {i} losses: {g!r} vs {w!r}")
    losses = numbers["losses"]
    if len(losses) != len(want_losses):
        errs.append(f"{name}: {len(losses)} steps, the twin's {len(want_losses)}")
    gap = max((abs(a - b) for a, b in zip(losses, want_losses)), default=0.0)
    if not gap <= TRAIN_LM_LOSS_TOL:
        errs.append(f"{name}: step losses differ from the twin's by {gap} > "
                    f"{TRAIN_LM_LOSS_TOL} (first at step "
                    f"{first_step_past(losses, want_losses, TRAIN_LM_LOSS_TOL)})")
    if not all(math.isfinite(x) for x in losses):
        errs.append(f"{name}: a loss is not finite")
    if not numbers["last"] < numbers["first"]:
        errs.append(f"{name}: loss {numbers['first']} → {numbers['last']} "
                    "did not fall")
    return errs


def check(name: str, printed: str, numbers: dict) -> list[str]:
    """What differs between a port example's run and its twin's lines
    (an empty list when nothing does)."""
    if name == TRAIN_LM:
        return check_train_lm(printed, numbers, LINES[name],
                              TRAIN_LM_STEP_LOSSES)
    want, got = LINES[name].splitlines(), printed.splitlines()
    errs = []
    if len(got) != len(want):
        errs.append(f"{name}: {len(got)} lines printed, the twin's {len(want)}")
    if name != GNN:
        return errs + [f"{name} line {i}: {g!r} != {w!r}"
                       for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if got[:1] != want[:1]:
        errs.append(f"{name} survey line: {got[:1]} != {want[:1]}")
    errs += [f"{name} line {i} format: {g!r} vs {w!r}"
             for i, (g, w) in enumerate(zip(got, want))
             if _masked(g) != _masked(w)]
    for run, trace in zip(("base", "tri"), GNN_STEP_LOSSES):
        r = numbers[run]
        steps = r["losses"][:TRACE_STEPS]
        gap = max(abs(a - b) for a, b in zip(steps, trace))
        if len(steps) < TRACE_STEPS or not gap <= LOSS_TOL:
            errs.append(f"{name} {run}: first {TRACE_STEPS} step losses "
                        f"{steps} differ from the twin's {trace[:TRACE_STEPS]} "
                        f"by {gap} > {LOSS_TOL}")
        if not all(math.isfinite(x) for x in r["losses"]):
            errs.append(f"{name} {run}: a loss is not finite")
        if not losses_fall(r["losses"]):
            errs.append(f"{name} {run}: the last {FALL_STEPS} step losses "
                        f"{r['losses'][-FALL_STEPS:]} did not fall below "
                        f"the first step's {r['losses'][0]}")
    if not numbers["gain"] > 0:
        errs.append(f"{name}: triangle-feature gain {numbers['gain']} <= 0")
    return errs


# --- recorded by tools/record_example_lines.py; do not edit ---
LINES = {'closure_survey': 'temporal graph: 3000 users, 117571 timestamped edges\n'
                   'triangles surveyed: 142909 (pushed 1255, pulled 141654)\n'
                   '\n'
                   'Δt_close distribution (log2-bucketed, Fig. 6 analog):\n'
                   '  2^11 .. 2^12 |        3 \n'
                   '  2^12 .. 2^13 |        5 \n'
                   '  2^13 .. 2^14 |       24 \n'
                   '  2^14 .. 2^15 |       85 \n'
                   '  2^15 .. 2^16 |      343 \n'
                   '  2^16 .. 2^17 |     1280 \n'
                   '  2^17 .. 2^18 |     5060 ###\n'
                   '  2^18 .. 2^19 |    17406 ##########\n'
                   '  2^19 .. 2^20 |    52263 ###############################\n'
                   '  2^20 .. 2^21 |    66440 ########################################\n'
                   '\n'
                   'modal open bucket: 2^19, modal close bucket: 2^20\n'
                   "(wedges form fast; closures lag with a heavy tail — the paper's qualitative "
                   'Reddit finding)\n',
 'hub_survey': 'rmat(12, 8): n=4096 m=26537, degree max=923 p99=184 median=2\n'
               '\n'
               'bytes per lane, S=8 shards (measured wire buffers):\n'
               '  dense        θ=0    hubs=0   hub-wedges=       0  push=  2.097MB  request=  '
               '0.088MB  reply=  9.247MB  hub_table=  0.000MB  total= 11.432MB\n'
               '  ragged       θ=0    hubs=0   hub-wedges=       0  push=  0.243MB  request=  '
               '0.024MB  reply=  2.490MB  hub_table=  0.000MB  total=  2.756MB\n'
               '  ragged+hub   θ=29   hubs=360 hub-wedges=  231815  push=  0.113MB  request=  '
               '0.008MB  reply=  0.356MB  hub_table=  1.388MB  total=  1.864MB\n'
               '\n'
               'identical results (count=134422); ragged 4.1x, ragged+hub 6.1x fewer exchanged '
               'bytes than dense\n'
               '\n'
               'θ sweep (analytic wire totals from the planner):\n'
               '  θ=451   hubs=5    hub-wedges=2325     hub-table= 0.001MB reply-rows≤52   wire=  '
               '2.730MB\n'
               '  θ=193   hubs=24   hub-wedges=29675    hub-table= 0.032MB reply-rows≤52   wire=  '
               '2.637MB\n'
               '  θ=184   hubs=43   hub-wedges=61266    hub-table= 0.093MB reply-rows≤52   wire=  '
               '2.575MB\n'
               '  θ=73    hubs=129  hub-wedges=157909   hub-table= 0.467MB reply-rows≤43   wire=  '
               '2.140MB\n'
               '  θ=26    hubs=436  hub-wedges=237500   hub-table= 1.576MB reply-rows≤23   wire=  '
               '1.945MB\n'
               '  θ=9     hubs=1073 hub-wedges=249916   hub-table= 2.688MB reply-rows≤7    wire=  '
               '2.707MB\n'
               '\n'
               'sweep minimum at θ=26 (1.945MB); planner auto chose θ=29 (1.864MB)\n',
 'label_survey': 'distinct 3-tuples: 56, collided slots: 0\n'
                 '\n'
                 "top label triangles (Sec 5.8 'amazon.com' analysis analog):\n"
                 "     2218  ('blog.io', 'news.org', 'shop.net')\n"
                 "     2071  ('wiki.org', 'blog.io', 'shop.net')\n"
                 "     2010  ('blog.io', 'amazon.com', 'shop.net')\n"
                 "     1985  ('blog.io', 'news.org', 'amazon.com')\n"
                 "     1970  ('blog.io', 'news.org', 'lib.edu')\n"
                 "     1920  ('blog.io', 'audible.com', 'news.org')\n"
                 "     1914  ('wiki.org', 'blog.io', 'news.org')\n"
                 "     1884  ('wiki.org', 'news.org', 'shop.net')\n"
                 "     1872  ('blog.io', 'audible.com', 'shop.net')\n"
                 "     1865  ('audible.com', 'news.org', 'shop.net')\n"
                 '\n'
                 'triangles involving amazon.com: 30973 across 21 label pairs\n',
 'multi_survey': 'temporal graph: 2000 users, 77585 timestamped edges\n'
                 'push entries: 9 words projected (full metadata: 9)\n'
                 '\n'
                 'one traversal (28271 wedges pushed, 6509 rows pulled) answered 4 surveys:\n'
                 '  triangles: 131291\n'
                 '  modal closure time: 2^20 s\n'
                 '  distinct label triples: 550 (most common (6, 11, 12))\n'
                 '  heaviest triangles (by Σ edge ts — latest-closing):\n'
                 '    (1585, 1040, 783)  weight 2971133\n'
                 '    (1337, 357, 391)  weight 2970710\n'
                 '    (1995, 654, 65)  weight 2958541\n'
                 '    (688, 254, 71)  weight 2955385\n'
                 '    (1842, 447, 6)  weight 2951104\n'
                 '\n'
                 'DOULION p=0.25: estimate 130816 vs exact 131291 (0.4% error, predicted '
                 'rel-stderr 2.2%)\n',
 'quickstart': 'graph: 512 vertices, 4810 undirected edges\n'
               'DODGr: |W+| = 40174 wedges, max out-degree 35\n'
               'push-only:  30178 triangles, 0.96 MB communicated (6 words/entry, full metadata '
               'would be 6)\n'
               'push-pull:  30178 triangles, 0.15 MB communicated (6.5x reduction, 92 '
               'pulls/shard)\n',
 'streaming_survey': 'stream: 57007 history edges, then 4 batches of ~150 timestamped edges\n'
                     '\n'
                     'epoch 1 (history): 117592 triangles\n'
                     'epoch 2: +150 edges → frontier 20905 of 57157 edges, 524657 of 701778 '
                     'frontier wedges generated; +944 new triangles (running total 118536)\n'
                     'epoch 3: +150 edges → frontier 20236 of 57307 edges, 413704 of 656902 '
                     'frontier wedges generated; +837 new triangles (running total 119373)\n'
                     'epoch 4: +150 edges → frontier 21228 of 57457 edges, 473614 of 623308 '
                     'frontier wedges generated; +952 new triangles (running total 120325)\n'
                     'epoch 5: +150 edges → frontier 21344 of 57607 edges, 365187 of 544921 '
                     'frontier wedges generated; +924 new triangles (running total 121249)\n'
                     '\n'
                     'full recompute agrees bitwise: count=True closure-histogram=True\n'
                     'final-epoch exchanged bytes: 1253860 incremental vs 3471296 recompute (2.8x '
                     'less)\n'
                     'modal closure time so far: 2^20 s\n',
 'train_lm': 'arch=internlm2-smoke params=0.4M vocab=512 layers=2\n'
             'step     0 loss 6.6147  2561.9 ms       400 tok/s\n'
             'step    10 loss 6.2749    75.5 ms     13564 tok/s\n'
             'step    20 loss 5.7306    70.2 ms     14579 tok/s\n'
             'step    30 loss 4.9563    68.3 ms     14989 tok/s\n'
             'step    40 loss 4.3423    68.0 ms     15061 tok/s\n'
             'step    50 loss 4.1968    87.2 ms     11737 tok/s\n'
             'step    60 loss 4.0749    81.5 ms     12568 tok/s\n'
             'step    70 loss 4.0571    89.2 ms     11479 tok/s\n'
             'step    80 loss 4.0201    89.9 ms     11388 tok/s\n'
             'step    90 loss 3.9761    72.2 ms     14192 tok/s\n'
             'step   100 loss 3.9555    68.4 ms     14967 tok/s\n'
             'step   110 loss 3.9710    68.0 ms     15068 tok/s\n'
             'step   120 loss 3.9809    78.3 ms     13074 tok/s\n'
             'step   130 loss 3.8999   107.0 ms      9571 tok/s\n'
             'step   140 loss 3.9821    73.6 ms     13921 tok/s\n'
             'step   150 loss 3.9549   116.9 ms      8756 tok/s\n'
             'step   160 loss 3.9673    77.8 ms     13163 tok/s\n'
             'step   170 loss 3.9371    69.4 ms     14764 tok/s\n'
             'step   180 loss 3.9620    67.1 ms     15253 tok/s\n'
             'step   190 loss 3.9287    77.6 ms     13202 tok/s\n'
             'done: loss 6.2760 → 3.9287\n',
 'triangle_features_gnn': 'triangle participation: max 1246, mean 80.53\n'
                          'baseline (degree only)      : loss 0.3371, accuracy 0.844\n'
                          'with TriPoll triangle feature: loss 0.1795, accuracy 0.934\n'
                          '\n'
                          'triangle-feature gain: +9.0 points\n'}

GNN_STEP_LOSSES = [[2.1402318477630615, 2.827746629714966, 0.8964966535568237, 2.4961414337158203, 2.4413511753082275,
  1.161940336227417, 0.9739971160888672, 0.7730092406272888, 0.6840999722480774, 0.5421606302261353,
  0.5916427969932556, 0.6939906477928162, 0.5838329195976257, 1.1302106380462646,
  1.2322723865509033, 0.5316304564476013, 0.5984046459197998, 0.592326819896698, 0.5256563425064087,
  0.5485683679580688, 0.476050466299057, 0.5944703817367554, 0.6087745428085327,
  0.48142826557159424, 0.6473831534385681, 0.8297122120857239, 0.5461297035217285,
  0.475219190120697, 0.4865798354148865, 0.4514296352863312, 0.4712718725204468,
  0.43779879808425903, 0.432478666305542, 0.4316820502281189, 0.37219905853271484,
  0.36840859055519104, 0.3619256615638733, 0.33449843525886536, 0.45535480976104736,
  0.39800000190734863, 0.3855154812335968, 0.4065169095993042, 0.32807451486587524,
  0.30981409549713135, 0.5261883735656738, 0.5419765114784241, 0.3082299530506134,
  1.0047013759613037, 1.674017071723938, 1.0991746187210083, 0.34622570872306824,
  0.5947655439376831, 0.8643582463264465, 0.7838444709777832, 0.4845656156539917,
  0.3099803924560547, 0.3779994547367096, 0.3346334397792816, 0.3261120021343231,
  0.33710795640945435],
 [3.6321346759796143, 1.9468458890914917, 5.611522674560547, 3.0483896732330322, 0.7575756907463074,
  0.687944769859314, 0.736213207244873, 0.7054252624511719, 0.5725281238555908, 0.6568427085876465,
  0.5361500382423401, 0.6259064078330994, 0.593506932258606, 0.49815207719802856,
  0.48134562373161316, 0.4539688527584076, 0.7323105931282043, 0.48024287819862366,
  0.6462050080299377, 0.5815437436103821, 0.446840763092041, 0.42678749561309814, 0.429130494594574,
  0.37862253189086914, 0.36211293935775757, 0.37218523025512695, 0.3171937167644501,
  0.4083888530731201, 0.2767045497894287, 0.669782280921936, 0.4004514515399933, 1.3212025165557861,
  1.7490209341049194, 0.3643437623977661, 1.0364949703216553, 1.315068244934082, 0.8458408117294312,
  0.28445932269096375, 0.3237559497356415, 0.2732127606868744, 0.2776491641998291,
  0.2606700658798218, 0.2819497287273407, 0.2550063133239746, 0.25514674186706543,
  0.2432444542646408, 0.23387327790260315, 0.22939111292362213, 0.23870283365249634,
  0.2151433825492859, 0.2361096292734146, 0.20431868731975555, 0.21844710409641266,
  0.19947189092636108, 0.20115815103054047, 0.1949729472398758, 0.1819101721048355,
  0.18807365000247955, 0.16885614395141602, 0.1794547438621521]]

TRAIN_LM_STEP_LOSSES = [6.614684581756592, 6.616873264312744, 6.559153079986572, 6.47588586807251, 6.491241931915283,
 6.450314998626709, 6.434809684753418, 6.388538360595703, 6.406304836273193, 6.307989597320557,
 6.274878978729248, 6.312936782836914, 6.199973106384277, 6.1175665855407715, 6.092721939086914,
 6.1114935874938965, 5.9976701736450195, 5.991879940032959, 5.851789474487305, 5.822713375091553,
 5.7305827140808105, 5.700984477996826, 5.598639011383057, 5.508545398712158, 5.443647384643555,
 5.352789878845215, 5.306024074554443, 5.116560459136963, 5.118652820587158, 5.082518577575684,
 4.956271648406982, 4.83133602142334, 4.832042217254639, 4.720033645629883, 4.658749580383301,
 4.664834022521973, 4.546103477478027, 4.492074489593506, 4.4937849044799805, 4.404147148132324,
 4.342287063598633, 4.321169853210449, 4.307534694671631, 4.28846549987793, 4.254226207733154,
 4.22934103012085, 4.249368190765381, 4.210383892059326, 4.183921813964844, 4.169040679931641,
 4.196770191192627, 4.148260116577148, 4.100117206573486, 4.152982711791992, 4.1283040046691895,
 4.078551769256592, 4.105709552764893, 4.081794261932373, 4.109494686126709, 4.077776908874512,
 4.074939250946045, 4.057563781738281, 4.0656890869140625, 4.042715072631836, 4.092465400695801,
 4.068686485290527, 4.07649564743042, 4.067662239074707, 4.097816467285156, 4.0197529792785645,
 4.057143211364746, 4.0557122230529785, 4.052953720092773, 4.04821252822876, 4.043056488037109,
 4.0284953117370605, 3.9978766441345215, 3.991462230682373, 3.986821174621582, 3.9890754222869873,
 4.020105838775635, 4.030472278594971, 4.052812576293945, 4.051629543304443, 4.00883150100708,
 3.9944279193878174, 3.9983980655670166, 3.9736063480377197, 4.038491725921631, 4.041428089141846,
 3.976104497909546, 3.9702725410461426, 3.9956552982330322, 4.015567302703857, 3.9749584197998047,
 3.99039888381958, 4.000888347625732, 3.961824655532837, 3.9629967212677, 3.9723198413848877,
 3.955471992492676, 3.9373574256896973, 3.933450222015381, 3.966012477874756, 3.9524102210998535,
 4.015624523162842, 4.005636692047119, 4.029870986938477, 4.017179489135742, 3.9714725017547607,
 3.971022844314575, 3.9536685943603516, 3.9822022914886475, 3.9996869564056396, 3.977142095565796,
 3.9938600063323975, 3.9490413665771484, 3.9195618629455566, 3.983187675476074, 3.961047887802124,
 3.9808666706085205, 3.9747660160064697, 3.9453606605529785, 3.9635303020477295, 3.9245643615722656,
 3.9616055488586426, 3.9671757221221924, 3.9319255352020264, 3.976369857788086, 3.927711009979248,
 3.899855613708496, 3.920055627822876, 3.939517021179199, 3.917221784591675, 3.9356689453125,
 3.900885581970215, 3.925339460372925, 3.944060802459717, 3.9466543197631836, 3.9276304244995117,
 3.982051134109497, 3.9636070728302, 3.925128698348999, 3.9460508823394775, 3.866729974746704,
 3.9455273151397705, 3.9407546520233154, 3.9110026359558105, 3.94303297996521, 3.9397196769714355,
 3.9549498558044434, 3.927252769470215, 3.972426652908325, 3.9515440464019775, 3.9233620166778564,
 3.9295146465301514, 3.899440050125122, 3.977839469909668, 3.9069712162017822, 3.962378978729248,
 3.9673261642456055, 3.8916983604431152, 3.951528549194336, 3.9411749839782715, 3.933175563812256,
 3.9256317615509033, 3.9083304405212402, 3.8860507011413574, 3.9880383014678955, 3.9209816455841064,
 3.9370646476745605, 3.9576191902160645, 3.928467035293579, 3.92002272605896, 3.9537227153778076,
 3.949639320373535, 3.932831048965454, 3.8979854583740234, 3.9362447261810303, 3.9251439571380615,
 3.9619641304016113, 3.9437813758850098, 3.9373090267181396, 3.910905599594116, 3.8925118446350098,
 3.9401891231536865, 3.9436280727386475, 3.940626621246338, 3.941072702407837, 3.903001308441162,
 3.9286861419677734, 3.949676275253296, 3.958925247192383, 3.9523401260375977, 3.9406747817993164,
 3.8764002323150635, 3.9350643157958984, 3.8913631439208984, 3.9308931827545166, 3.894400119781494]
