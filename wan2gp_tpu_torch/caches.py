"""Step-skipping caches: TeaCache and MagCache.

A copy of wan2gp_tpu/caches.py (numpy only).

Reference: models/wan/modules/model.py:1362-1474 (compute_*_threshold) and
:1861-1935 (in-forward skip logic); per-model coefficients in
models/wan/wan_handler.py:167-211.

KEY TPU INSIGHT: both caches' skip decisions depend only on the timestep
schedule (TeaCache: rel-L1 of the time-embedding trajectory; MagCache:
magnitude-ratio tables), NOT on the latents — the reference's own
auto-threshold search simulates decisions without running the model.  We
therefore precompute the whole skip schedule HOST-SIDE as a static bool[N]
and the compiled scan only branches (lax.cond) between "run block stack" and
"add cached residual".
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# TeaCache rescale polynomial coefficients (wan_handler.py:203-210)
TEACACHE_COEFFICIENTS = {
    "i2v_720p": [-114.36346466, 65.26524496, -18.82220707, 4.91518089,
                 -0.23412683],
    "i2v_480p": [-3.02331670e+02, 2.23948934e+02, -5.25463970e+01,
                 5.87348440e+00, -2.01973289e-01],
    "t2v_1.3B": [2.39676752e+03, -1.31110545e+03, 2.01331979e+02,
                 -8.29855975e+00, 1.37887774e-01],
    "t2v_14B": [-5784.54975374, 5449.50911966, -1811.16591783, 256.27178429,
                -13.02252404],
}


def teacache_coefficients(base_model_type: str, is_i2v: bool,
                          pixels: int) -> List[float]:
    if is_i2v:
        key = "i2v_720p" if pixels >= 1280 * 720 else "i2v_480p"
    elif "1.3B" in base_model_type:
        key = "t2v_1.3B"
    else:
        key = "t2v_14B"
    return TEACACHE_COEFFICIENTS[key]


def _teacache_decide(rel_l1s: np.ndarray, coefficients, thresh: float,
                     start_step: int) -> np.ndarray:
    """rel_l1s[i] = rel-L1 distance between time-embedding(t_i) and t_{i-1}
    (rel_l1s[0] unused).  Mirrors model.py:1895-1915."""
    n = len(rel_l1s)
    poly = np.poly1d(coefficients)
    should = np.ones(n, dtype=bool)
    accum = 0.0
    for i in range(n):
        if i <= start_step or i == n - 1:
            accum = 0.0
            continue
        delta = abs(poly(rel_l1s[i]))
        accum += delta
        if accum < thresh:
            should[i] = False
        else:
            accum = 0.0
    return should


def teacache_rel_l1s(e_list: Sequence[np.ndarray]) -> np.ndarray:
    """e_list: per-step time-embedding vectors (host arrays)."""
    out = np.zeros(len(e_list))
    for i in range(1, len(e_list)):
        prev = np.abs(np.asarray(e_list[i - 1], np.float64))
        out[i] = (np.abs(np.asarray(e_list[i], np.float64)
                         - np.asarray(e_list[i - 1], np.float64)).mean()
                  / prev.mean())
    return out


def teacache_schedule(e_list, coefficients, thresh: float,
                      start_step: int = 0) -> np.ndarray:
    return _teacache_decide(teacache_rel_l1s(e_list), coefficients, thresh,
                            start_step)


def teacache_auto_threshold(e_list, coefficients, speed_factor: float,
                            start_step: int = 0) -> float:
    """Search the threshold whose skip count best matches speed_factor
    (model.py:1425-1472)."""
    rel = teacache_rel_l1s(e_list)
    n = len(e_list)
    target = int(n / speed_factor)
    best_t, best_diff = 0.01, 10 ** 9
    t = 0.01
    while t <= 0.6:
        nb = int(_teacache_decide(rel, coefficients, t, start_step).sum())
        diff = abs(target - nb)
        if diff < best_diff:
            best_t, best_diff = t, diff
        elif diff > best_diff:
            break
        t += 0.01
    return best_t


# ---------------------------------------------------------------------------
# MagCache
# ---------------------------------------------------------------------------

def magcache_table(base_model_type: str, is_i2v: bool, pixels: int) -> str:
    """The name of the MAGCACHE_DEF_RATIOS table a Wan row calibrates
    with: Wan2.2's A14B rows and the 5B their own, Wan2.1 i2v by
    resolution (as `teacache_coefficients`), the 1.3B rows t2v_1.3B and
    every other 14B row t2v_14B.  (The JAX package keys on the base model
    type with t2v_1.3B / t2v_14B as the fallback, so i2v, t2v_2_2 and
    ti2v_2_2 run on the t2v_14B ratios there.)"""
    own = {"t2v_2_2": "t2v_2_2_moe", "i2v_2_2": "i2v_2_2",
           "ti2v_2_2": "ti2v_5B_t2v"}
    if base_model_type in own:
        return own[base_model_type]
    if is_i2v:
        return "i2v_720p" if pixels >= 1280 * 720 else "i2v_480p"
    return "t2v_1.3B" if "1.3B" in base_model_type else "t2v_14B"


def magcache_interp_ratios(def_mag_ratios: Sequence[float],
                           num_steps: int) -> np.ndarray:
    """Prepend [1,1] and nearest-interpolate the (cond, uncond) pairs to the
    active step count (model.py:1362-1378).  Returns [num_steps, 2]."""
    arr = np.concatenate([[1.0, 1.0], np.asarray(def_mag_ratios, np.float64)])
    pairs = arr.reshape(-1, 2)
    if len(pairs) == num_steps:
        return pairs

    def nearest(src, target):
        if target == 1:
            return np.array([src[-1]])
        scale = (len(src) - 1) / (target - 1)
        idx = np.round(np.arange(target) * scale).astype(int)
        return src[idx]

    return np.stack([nearest(pairs[:, 0], num_steps),
                     nearest(pairs[:, 1], num_steps)], axis=1)


def magcache_schedule(ratios: np.ndarray, thresh: float, K: int = 2,
                      start_step: int = 0,
                      branches: int = 2) -> np.ndarray:
    """Per-step calc decision, OR-combined across CFG branches so the joint
    batched forward runs when any branch needs it (model.py:1863-1888;
    branch-asymmetric skipping would split the batch)."""
    n = len(ratios)
    should = np.ones(n, dtype=bool)
    acc_ratio = np.ones(branches)
    acc_steps = np.zeros(branches, dtype=int)
    acc_err = np.zeros(branches)
    for i in range(n):
        if i <= start_step:
            continue
        calc_any = False
        for b in range(branches):
            acc_ratio[b] *= ratios[i, min(b, ratios.shape[1] - 1)]
            acc_steps[b] += 1
            acc_err[b] += abs(1 - acc_ratio[b])
            if not (acc_err[b] < thresh and acc_steps[b] <= K):
                calc_any = True
        if calc_any:
            acc_ratio[:] = 1.0
            acc_steps[:] = 0
            acc_err[:] = 0.0
            should[i] = True
        else:
            should[i] = False
    return should


def magcache_auto_threshold(ratios: np.ndarray, speed_factor: float,
                            K: int = 2, start_step: int = 0) -> float:
    n = len(ratios)
    target = int(n / speed_factor)
    best_t, best_diff = 0.01, 10 ** 9
    t = 0.01
    while t <= 0.6:
        nb = int(magcache_schedule(ratios, t, K, start_step).sum())
        diff = abs(target - nb)
        if diff < best_diff:
            best_t, best_diff = t, diff
        elif diff > best_diff:
            break
        t += 0.01
    return best_t
# MagCache magnitude-ratio tables (wan_handler.py:180-201; published
# MagCache calibration constants for each Wan variant)
MAGCACHE_DEF_RATIOS = {
    "t2v_2_2_moe": [1.00124, 1.00155, 0.99822, 0.99851, 0.99696, 0.99687, 0.99703, 0.99732, 0.9966, 0.99679, 0.99602, 0.99658, 0.99578, 0.99664, 0.99484, 0.9949, 0.99633, 0.996, 0.99659, 0.99683, 0.99534, 0.99549, 0.99584, 0.99577, 0.99681, 0.99694, 0.99563, 0.99554, 0.9944, 0.99473, 0.99594, 0.9964, 0.99466, 0.99461, 0.99453, 0.99481, 0.99389, 0.99365, 0.99391, 0.99406, 0.99354, 0.99361, 0.99283, 0.99278, 0.99268, 0.99263, 0.99057, 0.99091, 0.99125, 0.99126, 0.65523, 0.65252, 0.98808, 0.98852, 0.98765, 0.98736, 0.9851, 0.98535, 0.98311, 0.98339, 0.9805, 0.9806, 0.97776, 0.97771, 0.97278, 0.97286, 0.96731, 0.96728, 0.95857, 0.95855, 0.94385, 0.94385, 0.92118, 0.921, 0.88108, 0.88076, 0.80263, 0.80181],
    "i2v_2_2": [0.99191, 0.99144, 0.99356, 0.99337, 0.99326, 0.99285, 0.99251, 0.99264, 0.99393, 0.99366, 0.9943, 0.9943, 0.99276, 0.99288, 0.99389, 0.99393, 0.99274, 0.99289, 0.99316, 0.9931, 0.99379, 0.99377, 0.99268, 0.99271, 0.99222, 0.99227, 0.99175, 0.9916, 0.91076, 0.91046, 0.98931, 0.98933, 0.99087, 0.99088, 0.98852, 0.98855, 0.98895, 0.98896, 0.98806, 0.98808, 0.9871, 0.98711, 0.98613, 0.98618, 0.98434, 0.98435, 0.983, 0.98307, 0.98185, 0.98187, 0.98131, 0.98131, 0.9783, 0.97835, 0.97619, 0.9762, 0.97264, 0.9727, 0.97088, 0.97098, 0.96568, 0.9658, 0.96045, 0.96055, 0.95322, 0.95335, 0.94579, 0.94594, 0.93297, 0.93311, 0.91699, 0.9172, 0.89174, 0.89202, 0.8541, 0.85446, 0.79823, 0.79902],
    "ti2v_5B_t2v": [0.99505, 0.99389, 0.99441, 0.9957, 0.99558, 0.99551, 0.99499, 0.9945, 0.99534, 0.99548, 0.99468, 0.9946, 0.99463, 0.99458, 0.9946, 0.99453, 0.99408, 0.99404, 0.9945, 0.99441, 0.99409, 0.99398, 0.99403, 0.99397, 0.99382, 0.99377, 0.99349, 0.99343, 0.99377, 0.99378, 0.9933, 0.99328, 0.99303, 0.99301, 0.99217, 0.99216, 0.992, 0.99201, 0.99201, 0.99202, 0.99133, 0.99132, 0.99112, 0.9911, 0.99155, 0.99155, 0.98958, 0.98957, 0.98959, 0.98958, 0.98838, 0.98835, 0.98826, 0.98825, 0.9883, 0.98828, 0.98711, 0.98709, 0.98562, 0.98561, 0.98511, 0.9851, 0.98414, 0.98412, 0.98284, 0.98282, 0.98104, 0.98101, 0.97981, 0.97979, 0.97849, 0.97849, 0.97557, 0.97554, 0.97398, 0.97395, 0.97171, 0.97166, 0.96917, 0.96913, 0.96511, 0.96507, 0.96263, 0.96257, 0.95839, 0.95835, 0.95483, 0.95475, 0.94942, 0.94936, 0.9468, 0.94678, 0.94583, 0.94594, 0.94843, 0.94872, 0.96949, 0.97015],
    "ti2v_5B_i2v": [0.99512, 0.99559, 0.99559, 0.99561, 0.99595, 0.99577, 0.99512, 0.99512, 0.99546, 0.99534, 0.99543, 0.99531, 0.99496, 0.99491, 0.99504, 0.99499, 0.99444, 0.99449, 0.99481, 0.99481, 0.99435, 0.99435, 0.9943, 0.99431, 0.99411, 0.99406, 0.99373, 0.99376, 0.99413, 0.99405, 0.99363, 0.99359, 0.99335, 0.99331, 0.99244, 0.99243, 0.99229, 0.99229, 0.99239, 0.99236, 0.99163, 0.9916, 0.99149, 0.99151, 0.99191, 0.99192, 0.9898, 0.98981, 0.9899, 0.98987, 0.98849, 0.98849, 0.98846, 0.98846, 0.98861, 0.98861, 0.9874, 0.98738, 0.98588, 0.98589, 0.98539, 0.98534, 0.98444, 0.98439, 0.9831, 0.98309, 0.98119, 0.98118, 0.98001, 0.98, 0.97862, 0.97859, 0.97555, 0.97558, 0.97392, 0.97388, 0.97152, 0.97145, 0.96871, 0.9687, 0.96435, 0.96434, 0.96129, 0.96127, 0.95639, 0.95638, 0.95176, 0.95175, 0.94446, 0.94452, 0.93972, 0.93974, 0.93575, 0.9359, 0.93537, 0.93552, 0.96655, 0.96616],
    "t2v_1.3B": [1.0124, 1.02213, 1.00166, 1.0041, 0.99791, 1.00061, 0.99682, 0.99762, 0.99634, 0.99685, 0.99567, 0.99586, 0.99416, 0.99422, 0.99578, 0.99575, 0.9957, 0.99563, 0.99511, 0.99506, 0.99535, 0.99531, 0.99552, 0.99549, 0.99541, 0.99539, 0.9954, 0.99536, 0.99489, 0.99485, 0.99518, 0.99514, 0.99484, 0.99478, 0.99481, 0.99479, 0.99415, 0.99413, 0.99419, 0.99416, 0.99396, 0.99393, 0.99388, 0.99386, 0.99349, 0.99349, 0.99309, 0.99304, 0.9927, 0.9927, 0.99228, 0.99226, 0.99171, 0.9917, 0.99137, 0.99135, 0.99068, 0.99063, 0.99005, 0.99003, 0.98944, 0.98942, 0.98849, 0.98849, 0.98758, 0.98757, 0.98644, 0.98643, 0.98504, 0.98503, 0.9836, 0.98359, 0.98202, 0.98201, 0.97977, 0.97978, 0.97717, 0.97718, 0.9741, 0.97411, 0.97003, 0.97002, 0.96538, 0.96541, 0.9593, 0.95933, 0.95086, 0.95089, 0.94013, 0.94019, 0.92402, 0.92414, 0.90241, 0.9026, 0.86821, 0.86868, 0.81838, 0.81939],
    "i2v_720p": [0.99428, 0.99498, 0.98588, 0.98621, 0.98273, 0.98281, 0.99018, 0.99023, 0.98911, 0.98917, 0.98646, 0.98652, 0.99454, 0.99456, 0.9891, 0.98909, 0.99124, 0.99127, 0.99102, 0.99103, 0.99215, 0.99212, 0.99515, 0.99515, 0.99576, 0.99572, 0.99068, 0.99072, 0.99097, 0.99097, 0.99166, 0.99169, 0.99041, 0.99042, 0.99201, 0.99198, 0.99101, 0.99101, 0.98599, 0.98603, 0.98845, 0.98844, 0.98848, 0.98851, 0.98862, 0.98857, 0.98718, 0.98719, 0.98497, 0.98497, 0.98264, 0.98263, 0.98389, 0.98393, 0.97938, 0.9794, 0.97535, 0.97536, 0.97498, 0.97499, 0.973, 0.97301, 0.96827, 0.96828, 0.96261, 0.96263, 0.95335, 0.9534, 0.94649, 0.94655, 0.93397, 0.93414, 0.91636, 0.9165, 0.89088, 0.89109, 0.8679, 0.86768],
    "t2v_14B": [1.02504, 1.03017, 1.00025, 1.00251, 0.9985, 0.99962, 0.99779, 0.99771, 0.9966, 0.99658, 0.99482, 0.99476, 0.99467, 0.99451, 0.99664, 0.99656, 0.99434, 0.99431, 0.99533, 0.99545, 0.99468, 0.99465, 0.99438, 0.99434, 0.99516, 0.99517, 0.99384, 0.9938, 0.99404, 0.99401, 0.99517, 0.99516, 0.99409, 0.99408, 0.99428, 0.99426, 0.99347, 0.99343, 0.99418, 0.99416, 0.99271, 0.99269, 0.99313, 0.99311, 0.99215, 0.99215, 0.99218, 0.99215, 0.99216, 0.99217, 0.99163, 0.99161, 0.99138, 0.99135, 0.98982, 0.9898, 0.98996, 0.98995, 0.9887, 0.98866, 0.98772, 0.9877, 0.98767, 0.98765, 0.98573, 0.9857, 0.98501, 0.98498, 0.9838, 0.98376, 0.98177, 0.98173, 0.98037, 0.98035, 0.97678, 0.97677, 0.97546, 0.97543, 0.97184, 0.97183, 0.96711, 0.96708, 0.96349, 0.96345, 0.95629, 0.95625, 0.94926, 0.94929, 0.93964, 0.93961, 0.92511, 0.92504, 0.90693, 0.90678, 0.8796, 0.87945, 0.86111, 0.86189],
    "i2v_480p": [0.98783, 0.98993, 0.97559, 0.97593, 0.98311, 0.98319, 0.98202, 0.98225, 0.9888, 0.98878, 0.98762, 0.98759, 0.98957, 0.98971, 0.99052, 0.99043, 0.99383, 0.99384, 0.98857, 0.9886, 0.99065, 0.99068, 0.98845, 0.98847, 0.99057, 0.99057, 0.98957, 0.98961, 0.98601, 0.9861, 0.98823, 0.98823, 0.98756, 0.98759, 0.98808, 0.98814, 0.98721, 0.98724, 0.98571, 0.98572, 0.98543, 0.98544, 0.98157, 0.98165, 0.98411, 0.98413, 0.97952, 0.97953, 0.98149, 0.9815, 0.9774, 0.97742, 0.97825, 0.97826, 0.97355, 0.97361, 0.97085, 0.97087, 0.97056, 0.97055, 0.96588, 0.96587, 0.96113, 0.96124, 0.9567, 0.95681, 0.94961, 0.94969, 0.93973, 0.93988, 0.93217, 0.93224, 0.91878, 0.91896, 0.90955, 0.90954, 0.92617, 0.92616],
}
