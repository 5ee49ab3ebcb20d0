"""Config keys and defaults (copy of deepspeed_tpu/runtime/constants.py for
the PyTorch port) — analog of reference ``deepspeed/runtime/constants.py``.

Key names are kept byte-identical with the reference JSON schema so existing
DeepSpeed config files parse unchanged.
"""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
ZERO_FORCE_DS_CPU_OPTIMIZER = "zero_force_ds_cpu_optimizer"
ZERO_FORCE_DS_CPU_OPTIMIZER_DEFAULT = True

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False
FP16_AUTO_CAST = "auto_cast"
FP16_AUTO_CAST_DEFAULT = False

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # legacy key accepted by the reference too
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False

AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

#############################################
# Logging / monitoring
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
# monitor cadence decoupled from print cadence: 0 =
# legacy behaviour (monitor writes ride steps_per_print)
MONITOR_INTERVAL = "monitor_interval"
MONITOR_INTERVAL_DEFAULT = 0
# training resilience section: anomaly sentinel + rewind-and-skip
# auto-recovery + SDC audits
RESILIENCE = "resilience"
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

#############################################
# Misc runtime
#############################################
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False
COMMUNICATION_DATA_TYPE = "communication_data_type"
COMMUNICATION_DATA_TYPE_DEFAULT = None
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
GRADIENT_NOISE_SCALE = "gradient_noise_scale"

SEED = "seed"
SEED_DEFAULT = 1234

#############################################
# Parallelism (TPU-native extensions: the reference delegates TP to a user
# mpu object and has no sequence axis; here they are config-first)
#############################################
TENSOR_PARALLEL = "tensor_parallel"
TENSOR_PARALLEL_SIZE = "tp_size"
PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
SEQUENCE_PARALLEL = "sequence_parallel"
SEQUENCE_PARALLEL_SIZE = "sp_size"
SEQUENCE_PARALLEL_MODE = "mode"  # "ring" | "ulysses"
EXPERT_PARALLEL_SIZE = "ep_size"

#############################################
# Activation checkpointing
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"

#############################################
# Data efficiency / types
#############################################
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False
DATA_EFFICIENCY = "data_efficiency"
DATA_TYPES = "data_types"

#############################################
# Checkpoint
#############################################
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal_checkpoint"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False
USE_NODE_LOCAL_STORAGE_CHECKPOINT = "use_node_local_storage"
CHECKPOINT_PARALLEL_WRITE = "parallel_write"
CHECKPOINT_TAG_VALIDATION = "checkpoint_tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]

#############################################
# Elasticity / compression / monitor keys live in their sub-packages
#############################################
ELASTICITY = "elasticity"
COMPRESSION_TRAINING = "compression_training"

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
