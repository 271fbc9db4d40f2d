"""CFPNet model modules (port of ``cfpnet_tpu/models``)."""
