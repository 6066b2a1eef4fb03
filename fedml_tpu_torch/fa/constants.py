"""Federated-analytics task names — counterpart of ``fedml_tpu/fa/constants.py``,
string for string (AVG, heavy hitter (TrieHH), union, intersection,
cardinality, frequency estimation, k-percentile, histogram)."""
FA_TASK_AVG = "avg"
FA_TASK_HEAVY_HITTER_TRIEHH = "heavy_hitter_triehh"
FA_TASK_UNION = "union"
FA_TASK_INTERSECTION = "intersection"
FA_TASK_CARDINALITY = "cardinality"
FA_TASK_FREQ = "frequency_estimation"
FA_TASK_K_PERCENTILE = "k_percentile_element"
FA_TASK_HISTOGRAM = "histogram"

ALL_TASKS = (
    FA_TASK_AVG,
    FA_TASK_HEAVY_HITTER_TRIEHH,
    FA_TASK_UNION,
    FA_TASK_INTERSECTION,
    FA_TASK_CARDINALITY,
    FA_TASK_FREQ,
    FA_TASK_K_PERCENTILE,
    FA_TASK_HISTOGRAM,
)
