"""repro_torch.pipeline — the paper's six-stage PCAP → database pipeline:
the libpcap codec and traffic generator (:mod:`.pcap`), the stages
(:mod:`.stages`), the fault-tolerant runner (:mod:`.runner`) and the
task-DAG driver (:mod:`.driver`)."""
from .driver import PipelineConfig, build_tasks, run_pipeline
from .pcap import TrafficConfig, botnet_truth, read_pcap, records_to_tsv, \
    synth_packets, write_pcap
from .runner import FaultInjector, Journal, Runner, Task, WorkerKilled
from . import stages

__all__ = [
    "PipelineConfig", "build_tasks", "run_pipeline",
    "TrafficConfig", "synth_packets", "write_pcap", "read_pcap",
    "records_to_tsv", "botnet_truth", "Runner", "Task", "Journal",
    "FaultInjector", "WorkerKilled", "stages",
]
