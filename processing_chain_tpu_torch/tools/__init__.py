"""Device halves of the chain's tools (port of processing_chain_tpu/tools/)."""
