#!/bin/bash
# Full fine-tuning of the t2v-14B DiT with the PyTorch port on one node of
# 8 cards (the counterpart of scripts/finetune.sh for the JAX package, the
# reference's 14B recipe): one rank per card under torchrun, 8-way Ulysses
# sequence parallelism, the block weights, their gradients and AdamW
# moments held as shards over the 8 ranks and gathered per block, batch 1,
# gradient checkpointing, bf16 compute, lr 1e-6. NCCL carries the
# collectives; rank 0 logs and writes the checkpoints. With 16 cards the
# same command runs 2 data-parallel groups of 8.
torchrun --nproc_per_node 8 -m moviigen_tpu_torch.cli.finetune \
    --task t2v-14B \
    --ckpt_dir ./Wan2.1-T2V-14B \
    --data_json_path data/preprocess/videos2caption_latest.json \
    --sp_size 8 \
    --train_batch_size 1 \
    --num_latent_t 21 \
    --gradient_checkpointing \
    --learning_rate 1e-6 \
    --weighting_scheme uniform \
    --max_train_steps 6000 \
    --checkpointing_steps 500 \
    --gradient_accumulation_steps 1 \
    --output_dir outputs/finetune
