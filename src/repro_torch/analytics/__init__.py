"""repro_torch.analytics — network analytics over associative arrays."""
from .anomaly import C2Report, C2Scores, ScanReport, c2_scores, \
    detect_c2, scan_detect, scan_hits, scan_report
from .powerlaw import PowerLawFit, background_scores, degree_histogram, \
    fit_degree_table, fit_rank_size
from .serialize import to_jsonable
from . import distributed

__all__ = [
    "detect_c2", "c2_scores", "scan_detect", "scan_hits", "scan_report",
    "C2Report", "C2Scores", "ScanReport",
    "fit_rank_size", "fit_degree_table", "degree_histogram",
    "background_scores", "PowerLawFit",
    "to_jsonable",
    "distributed",
]
