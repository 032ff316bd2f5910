"""Trackers over fixed-slot track state, batched over streams (ByteTrack,
BoT-SORT, StrongSORT, the flow_tpu camera-motion estimate), and the
offline StrongSORT++ pass (GSI, tracklet linking, the AFLink net)."""
