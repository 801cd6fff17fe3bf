"""repro_torch.pipeline — packet capture and the synthetic traffic model.

The port has the libpcap codec and generator (:mod:`.pcap`); the staged
pipeline, runner and driver are not ported yet.
"""
from .pcap import TrafficConfig, botnet_truth, read_pcap, records_to_tsv, \
    synth_packets, write_pcap

__all__ = ["TrafficConfig", "synth_packets", "write_pcap", "read_pcap",
           "records_to_tsv", "botnet_truth"]
