"""Stem selection math of the port: schedules, metrics, selection, policies,
and the decode / chunked-prefill stages of the paged serving lanes."""
