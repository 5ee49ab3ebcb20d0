// Kernel C (block_decode_step.cuh) over int8 pools: its instantiations, in a
// source of their own so that nvcc builds them beside the others.
#include "block_decode_step.cuh"

namespace dst {
namespace blockstep {

DST_BLOCKSTEP_POOL(, int8_t)

}  // namespace blockstep
}  // namespace dst
