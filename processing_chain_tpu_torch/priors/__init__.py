"""Codec-prior features (port of processing_chain_tpu/priors/features.py;
the extraction and the sidecar store are not ported yet)."""
