"""repro_torch.stream — streaming temporal analytics over async ingest.

Hierarchical time-bucket rollups riding the WriterPool ingest tap
(:mod:`.windows`), online detectors with root-cause localization
(:mod:`.detectors`), and the seeded synthetic traffic scenario harness
that grounds them in known truth (:mod:`.synth`).
"""
from .windows import LEVEL_SECONDS, TemporalRollup, WindowSummary
from .detectors import AlertReport, DetectorBank, RootCauseReport, \
    StreamAnalytics, WesternElectric, root_cause
from .synth import AttackSpec, ScenarioConfig, records_to_incidence, \
    scenario_incidence, scenario_truth, stream_blocks, synth_scenario

__all__ = [
    "LEVEL_SECONDS", "TemporalRollup", "WindowSummary",
    "AlertReport", "DetectorBank", "RootCauseReport", "StreamAnalytics",
    "WesternElectric", "root_cause",
    "AttackSpec", "ScenarioConfig", "records_to_incidence",
    "scenario_incidence", "scenario_truth", "stream_blocks",
    "synth_scenario",
]
