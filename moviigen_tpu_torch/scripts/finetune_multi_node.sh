#!/bin/bash
# Multi-node fine-tuning with the PyTorch port (the counterpart of
# scripts/finetune_multi_node.sh for the JAX package): run this script on
# every node with NNODES, NODE_RANK and MASTER_ADDR set (MASTER_PORT
# optional). Each node runs 8 ranks, one per card; the 8-way sequence
# parallelism stays inside a node and the data-parallel groups span the
# nodes (parallel.mesh.make_pod_mesh).
: "${NNODES:?set NNODES to the number of nodes}"
: "${NODE_RANK:?set NODE_RANK to this node's index, 0 .. NNODES - 1}"
: "${MASTER_ADDR:?set MASTER_ADDR to node 0's address}"
torchrun \
    --nnodes "$NNODES" \
    --node_rank "$NODE_RANK" \
    --nproc_per_node 8 \
    --master_addr "$MASTER_ADDR" \
    --master_port "${MASTER_PORT:-29500}" \
    -m moviigen_tpu_torch.cli.finetune \
    --task t2v-14B \
    --ckpt_dir ./Wan2.1-T2V-14B \
    --data_json_path data/preprocess/videos2caption_latest.json \
    --sp_size 8 \
    --train_batch_size 1 \
    --num_latent_t 21 \
    --gradient_checkpointing \
    --learning_rate 1e-6 \
    --max_train_steps 6000 \
    --checkpointing_steps 500 \
    --output_dir outputs/finetune
