// Kernel C (block_decode_step.cuh) over fp8 e4m3 pools: its instantiations, in a
// source of their own so that nvcc builds them beside the others.
#include "block_decode_step.cuh"

namespace dst {
namespace blockstep {

DST_BLOCKSTEP_POOL(, fp8_t)

}  // namespace blockstep
}  // namespace dst
