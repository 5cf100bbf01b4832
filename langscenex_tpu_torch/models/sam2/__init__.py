"""SAM2 video segmentation: the Hiera image encoder, the prompt encoder and
mask decoder, the streaming memory, video propagation and SAM-style
automatic mask generation (port of the JAX ``models/sam2``)."""
