#!/bin/bash
# Multi-GPU inference with the PyTorch port: one rank per card under
# torchrun, 4-way Ulysses sequence parallelism, the DiT's and the umT5's
# block weights held as shards over the ranks and gathered per block (the
# counterpart of scripts/inference.sh for the JAX package). NCCL carries
# the collectives; rank 0 writes the video. Two or more ranks need as many
# cards; with --device cpu the ranks run over gloo.
torchrun --nproc_per_node 4 -m moviigen_tpu_torch.cli.generate \
    --task t2v-14B \
    --size "1280*720" \
    --ckpt_dir ./Wan2.1-T2V-14B \
    --ulysses_size 4 \
    --ring_size 1 \
    --dit_fsdp --t5_fsdp \
    --sample_steps 50 \
    --sample_shift 5.0 \
    --sample_guide_scale 5.0 \
    --prompt "Two anthropomorphic cats in comfy boxing gear and bright gloves fight intensely on a spotlighted stage."
