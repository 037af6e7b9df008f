// JAX's threefry2x32 stream on sm_90a: the RANSAC hypotheses' draws of the
// port, keyed as the reference keys them.
//
// threefry_categorical: jax.random.categorical(k, logits[p], shape) for
// P keys x J fold paths in one launch, the indices only. Entry (p, j, h)
// is argmax over m of gumbel(k_pj)[h, m] + logits[p, m] (one float32 add,
// the first index on ties), k_pj = fold(... fold(fold(keys[p], index[p]),
// path[j][0]) ..., path[j][L-1]) (fold(k, d): the hash of the counter
// pair (0, d) under k, JAX's fold_in and split(k, n)[d] in partitionable
// mode; the index is optional). The RANSAC steps call it: the Gumbel-max
// draws of a solve, its logits log(w + 1e-9) of the match mask.
//
// Value i of field k is -log(-log(u)), u the uniform in [tiny, 1) of the
// 32 bits h1 ^ h2 of the hash of (0, i) under k: jax.random.gumbel(k,
// shape) with jax_threefry_partitionable (jax 0.9's default). The logs are
// the twin's (utils/prng.py::log_f32), each operation rounded as the
// twin's (no contraction), so kernel and twin agree index for index.
//
// What bounds it on an H100 (no profiler runs there; the SASS and the
// ablations of scripts/torch_draw_ablation.py, PERF.md): per value the
// loop issues ~97 integer instructions (the 20-round hash's 75 operations,
// the logs' bit handling, the uniform, the maximum), ~38 float64 (two
// logs, their conversions) and ~8 float32. The bound counts the hash's 75
// at 64 a cycle per SM (16.7 T/s). Bytes are nothing beside them: the
// logits are read once per row and 8 bytes are written per row of M
// values. A call of the main path's size (786,432 values, 1,024 rows) also
// pays ~3.8 us that no hash or log takes: the launch (~1.1 us), the keys'
// fold chains (~0.5 us), the table, the loop's skeleton and the
// reduction. Design:
// - a warp owns an output row, two warps where the call has too few rows
//   to fill the card (the main path's 1,024 rows: ~15.5 warps per SM
//   instead of ~7.8, which leave the dependent chains' latency exposed);
//   each lane adds the logit to its values (loaded a round ahead, the
//   first before the block's barrier) and keeps a running (score, index)
//   maximum, and a warp shuffle (then shared memory across a row's two
//   warps) reduces it, the larger score winning and on equal scores the
//   smaller index; no field reaches device memory;
// - a lane runs kChains values through each step before the next, with no
//   branch until the maximum (a counter past the row is hashed too and its
//   score dropped), so that the dependent chains of the hash and of the
//   logs interleave;
// - each log is a table of 257 centres (1/c_j, log c_j as float64
//   literals, staged once per block in shared memory) and a 6-term log1p
//   series: ~17 float64 operations and no division, its bit handling 8
//   integer operations, the exponent made a float64 by an exact
//   subtraction (no conversion);
// - the fold chains of the block's fields are derived in parallel, a
//   thread each, into shared memory.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // warps per block
constexpr int kChains = 4;      // counters in flight per lane
constexpr int kTargetWarps = 4096;   // 132 SMs x ~32 warps
constexpr int kMaxFolds = 16;   // path entries of all fields together
constexpr int kLogTable = 256;   // centres per binade; the table has 257

// (1/c_j, log c_j), c_j = 1 + j/256, j = 0..256: utils/prng.py's INV_CENTRES
// (a correctly rounded float64 division) and LOG_CENTRES (decimal
// arithmetic, rounded once); tests/test_torch_prng.py holds them equal.
__device__ const double2 kLogCentre[kLogTable + 1] = {
    {0x1.0000000000000p+0, 0x0.0p+0},
    {0x1.fe01fe01fe020p-1, 0x1.ff00aa2b10bc0p-9},
    {0x1.fc07f01fc07f0p-1, 0x1.fe02a6b106789p-8},
    {0x1.fa11caa01fa12p-1, 0x1.7dc475f810a77p-7},
    {0x1.f81f81f81f820p-1, 0x1.fc0a8b0fc03e4p-7},
    {0x1.f6310aca0dbb5p-1, 0x1.3cea44346a575p-6},
    {0x1.f44659e4a4271p-1, 0x1.7b91b07d5b11bp-6},
    {0x1.f25f644230ab5p-1, 0x1.b9fc027af9198p-6},
    {0x1.f07c1f07c1f08p-1, 0x1.f829b0e783300p-6},
    {0x1.ee9c7f8458e02p-1, 0x1.1b0d98923d980p-5},
    {0x1.ecc07b301ecc0p-1, 0x1.39e87b9febd60p-5},
    {0x1.eae807aba01ebp-1, 0x1.58a5bafc8e4d5p-5},
    {0x1.e9131abf0b767p-1, 0x1.77458f632dcfcp-5},
    {0x1.e741aa59750e4p-1, 0x1.95c830ec8e3ebp-5},
    {0x1.e573ac901e574p-1, 0x1.b42dd711971bfp-5},
    {0x1.e3a9179dc1a73p-1, 0x1.d276b8adb0b52p-5},
    {0x1.e1e1e1e1e1e1ep-1, 0x1.f0a30c01162a6p-5},
    {0x1.e01e01e01e01ep-1, 0x1.075983598e471p-4},
    {0x1.de5d6e3f8868ap-1, 0x1.16536eea37ae1p-4},
    {0x1.dca01dca01dcap-1, 0x1.253f62f0a1417p-4},
    {0x1.dae6076b981dbp-1, 0x1.341d7961bd1d1p-4},
    {0x1.d92f2231e7f8ap-1, 0x1.42edcbea646f0p-4},
    {0x1.d77b654b82c34p-1, 0x1.51b073f06183fp-4},
    {0x1.d5cac807572b2p-1, 0x1.60658a93750c4p-4},
    {0x1.d41d41d41d41dp-1, 0x1.6f0d28ae56b4cp-4},
    {0x1.d272ca3fc5b1ap-1, 0x1.7da766d7b12cdp-4},
    {0x1.d0cb58f6ec074p-1, 0x1.8c345d6319b21p-4},
    {0x1.cf26e5c44bfc6p-1, 0x1.9ab42462033adp-4},
    {0x1.cd85689039b0bp-1, 0x1.a926d3a4ad563p-4},
    {0x1.cbe6d9601cbe7p-1, 0x1.b78c82bb0eda1p-4},
    {0x1.ca4b3055ee191p-1, 0x1.c5e548f5bc743p-4},
    {0x1.c8b265afb8a42p-1, 0x1.d4313d66cb35dp-4},
    {0x1.c71c71c71c71cp-1, 0x1.e27076e2af2e6p-4},
    {0x1.c5894d10d4986p-1, 0x1.f0a30c01162a6p-4},
    {0x1.c3f8f01c3f8f0p-1, 0x1.fec9131dbeabbp-4},
    {0x1.c26b5392ea01cp-1, 0x1.0671512ca596ep-3},
    {0x1.c0e070381c0e0p-1, 0x1.0d77e7cd08e59p-3},
    {0x1.bf583ee868d8bp-1, 0x1.14785846742acp-3},
    {0x1.bdd2b899406f7p-1, 0x1.1b72ad52f67a0p-3},
    {0x1.bc4fd65883e7bp-1, 0x1.2266f190a5acbp-3},
    {0x1.bacf914c1bad0p-1, 0x1.29552f81ff523p-3},
    {0x1.b951e2b18ff23p-1, 0x1.303d718e47fd3p-3},
    {0x1.b7d6c3dda338bp-1, 0x1.371fc201e8f74p-3},
    {0x1.b65e2e3beee05p-1, 0x1.3dfc2b0ecc62ap-3},
    {0x1.b4e81b4e81b4fp-1, 0x1.44d2b6ccb7d1ep-3},
    {0x1.b37484ad806cep-1, 0x1.4ba36f39a55e5p-3},
    {0x1.b2036406c80d9p-1, 0x1.526e5e3a1b438p-3},
    {0x1.b094b31d922a4p-1, 0x1.59338d9982086p-3},
    {0x1.af286bca1af28p-1, 0x1.5ff3070a793d4p-3},
    {0x1.adbe87f94905ep-1, 0x1.66acd4272ad51p-3},
    {0x1.ac5701ac5701bp-1, 0x1.6d60fe719d21dp-3},
    {0x1.aaf1d2f87ebfdp-1, 0x1.740f8f54037a5p-3},
    {0x1.a98ef606a63bep-1, 0x1.7ab890210d909p-3},
    {0x1.a82e65130e159p-1, 0x1.815c0a14357ebp-3},
    {0x1.a6d01a6d01a6dp-1, 0x1.87fa06520c911p-3},
    {0x1.a574107688a4ap-1, 0x1.8e928de886d41p-3},
    {0x1.a41a41a41a41ap-1, 0x1.9525a9cf456b4p-3},
    {0x1.a2c2a87c51ca0p-1, 0x1.9bb362e7dfb83p-3},
    {0x1.a16d3f97a4b02p-1, 0x1.a23bc1fe2b563p-3},
    {0x1.a01a01a01a01ap-1, 0x1.a8becfc882f19p-3},
    {0x1.9ec8e951033d9p-1, 0x1.af3c94e80bff3p-3},
    {0x1.9d79f176b682dp-1, 0x1.b5b519e8fb5a4p-3},
    {0x1.9c2d14ee4a102p-1, 0x1.bc286742d8cd6p-3},
    {0x1.9ae24ea5510dap-1, 0x1.c2968558c18c1p-3},
    {0x1.999999999999ap-1, 0x1.c8ff7c79a9a22p-3},
    {0x1.9852f0d8ec0ffp-1, 0x1.cf6354e09c5dcp-3},
    {0x1.970e4f80cb872p-1, 0x1.d5c216b4fbb91p-3},
    {0x1.95cbb0be377aep-1, 0x1.dc1bca0abec7dp-3},
    {0x1.948b0fcd6e9e0p-1, 0x1.e27076e2af2e6p-3},
    {0x1.934c67f9b2ce6p-1, 0x1.e8c0252aa5a60p-3},
    {0x1.920fb49d0e229p-1, 0x1.ef0adcbdc5936p-3},
    {0x1.90d4f120190d5p-1, 0x1.f550a564b7b37p-3},
    {0x1.8f9c18f9c18fap-1, 0x1.fb9186d5e3e2bp-3},
    {0x1.8e6527af1373fp-1, 0x1.00e6c45ad501dp-2},
    {0x1.8d3018d3018d3p-1, 0x1.0402594b4d041p-2},
    {0x1.8bfce8062ff3ap-1, 0x1.071b85fcd590dp-2},
    {0x1.8acb90f6bf3aap-1, 0x1.0a324e27390e3p-2},
    {0x1.899c0f601899cp-1, 0x1.0d46b579ab74bp-2},
    {0x1.886e5f0abb04ap-1, 0x1.1058bf9ae4ad5p-2},
    {0x1.87427bcc092b9p-1, 0x1.136870293a8b0p-2},
    {0x1.8618618618618p-1, 0x1.1675cababa60ep-2},
    {0x1.84f00c2780614p-1, 0x1.1980d2dd4236fp-2},
    {0x1.83c977ab2beddp-1, 0x1.1c898c16999fbp-2},
    {0x1.82a4a0182a4a0p-1, 0x1.1f8ff9e48a2f3p-2},
    {0x1.8181818181818p-1, 0x1.22941fbcf7966p-2},
    {0x1.8060180601806p-1, 0x1.2596010df763ap-2},
    {0x1.7f405fd017f40p-1, 0x1.2895a13de86a3p-2},
    {0x1.7e225515a4f1dp-1, 0x1.2b9303ab89d25p-2},
    {0x1.7d05f417d05f4p-1, 0x1.2e8e2bae11d31p-2},
    {0x1.7beb3922e017cp-1, 0x1.31871c9544185p-2},
    {0x1.7ad2208e0ecc3p-1, 0x1.347dd9a987d55p-2},
    {0x1.79baa6bb6398bp-1, 0x1.3772662bfd85bp-2},
    {0x1.78a4c8178a4c8p-1, 0x1.3a64c556945eap-2},
    {0x1.77908119ac60dp-1, 0x1.3d54fa5c1f710p-2},
    {0x1.767dce434a9b1p-1, 0x1.404308686a7e4p-2},
    {0x1.756cac201756dp-1, 0x1.432ef2a04e814p-2},
    {0x1.745d1745d1746p-1, 0x1.4618bc21c5ec2p-2},
    {0x1.734f0c541fe8dp-1, 0x1.49006804009d1p-2},
    {0x1.724287f46debcp-1, 0x1.4be5f957778a1p-2},
    {0x1.713786d9c7c09p-1, 0x1.4ec973260026ap-2},
    {0x1.702e05c0b8170p-1, 0x1.51aad872df82dp-2},
    {0x1.6f26016f26017p-1, 0x1.548a2c3add263p-2},
    {0x1.6e1f76b4337c7p-1, 0x1.5767717455a6cp-2},
    {0x1.6d1a62681c861p-1, 0x1.5a42ab0f4cfe2p-2},
    {0x1.6c16c16c16c17p-1, 0x1.5d1bdbf5809cap-2},
    {0x1.6b1490aa31a3dp-1, 0x1.5ff3070a793d4p-2},
    {0x1.6a13cd1537290p-1, 0x1.62c82f2b9c795p-2},
    {0x1.691473a88d0c0p-1, 0x1.659b57303e1f3p-2},
    {0x1.6816816816817p-1, 0x1.686c81e9b14afp-2},
    {0x1.6719f3601671ap-1, 0x1.6b3bb2235943ep-2},
    {0x1.661ec6a5122f9p-1, 0x1.6e08eaa2ba1e4p-2},
    {0x1.6524f853b4aa3p-1, 0x1.70d42e2789236p-2},
    {0x1.642c8590b2164p-1, 0x1.739d7f6bbd007p-2},
    {0x1.63356b88ac0dep-1, 0x1.7664e1239dbcfp-2},
    {0x1.623fa77016240p-1, 0x1.792a55fdd47a2p-2},
    {0x1.614b36831ae94p-1, 0x1.7bede0a37afc0p-2},
    {0x1.6058160581606p-1, 0x1.7eaf83b82afc3p-2},
    {0x1.5f66434292dfcp-1, 0x1.816f41da0d496p-2},
    {0x1.5e75bb8d015e7p-1, 0x1.842d1da1e8b17p-2},
    {0x1.5d867c3ece2a5p-1, 0x1.86e919a330ba0p-2},
    {0x1.5c9882b931057p-1, 0x1.89a3386c1425bp-2},
    {0x1.5babcc647fa91p-1, 0x1.8c5b7c858b48bp-2},
    {0x1.5ac056b015ac0p-1, 0x1.8f11e873662c7p-2},
    {0x1.59d61f123ccaap-1, 0x1.91c67eb45a83ep-2},
    {0x1.58ed2308158edp-1, 0x1.947941c2116fbp-2},
    {0x1.5805601580560p-1, 0x1.972a341135158p-2},
    {0x1.571ed3c506b3ap-1, 0x1.99d958117e08bp-2},
    {0x1.56397ba7c52e2p-1, 0x1.9c86b02dc0863p-2},
    {0x1.5555555555555p-1, 0x1.9f323ecbf984cp-2},
    {0x1.54725e6bb82fep-1, 0x1.a1dc064d5b995p-2},
    {0x1.5390948f40febp-1, 0x1.a484090e5bb0ap-2},
    {0x1.52aff56a8054bp-1, 0x1.a72a4966bd9eap-2},
    {0x1.51d07eae2f815p-1, 0x1.a9cec9a9a084ap-2},
    {0x1.50f22e111c4c5p-1, 0x1.ac718c258b0e4p-2},
    {0x1.5015015015015p-1, 0x1.af1293247786bp-2},
    {0x1.4f38f62dd4c9bp-1, 0x1.b1b1e0ebdfc5bp-2},
    {0x1.4e5e0a72f0539p-1, 0x1.b44f77bcc8f63p-2},
    {0x1.4d843bedc2c4cp-1, 0x1.b6eb59d3cf35ep-2},
    {0x1.4cab88725af6ep-1, 0x1.b9858969310fbp-2},
    {0x1.4bd3edda68fe1p-1, 0x1.bc1e08b0dad0ap-2},
    {0x1.4afd6a052bf5bp-1, 0x1.beb4d9da71b7cp-2},
    {0x1.4a27fad76014ap-1, 0x1.c149ff115f027p-2},
    {0x1.49539e3b2d067p-1, 0x1.c3dd7a7cdad4dp-2},
    {0x1.4880522014880p-1, 0x1.c66f4e3ff6ff8p-2},
    {0x1.47ae147ae147bp-1, 0x1.c8ff7c79a9a22p-2},
    {0x1.46dce34596066p-1, 0x1.cb8e0744d7acap-2},
    {0x1.460cbc7f5cf9ap-1, 0x1.ce1af0b85f3ebp-2},
    {0x1.453d9e2c776cap-1, 0x1.d0a63ae721e64p-2},
    {0x1.446f86562d9fbp-1, 0x1.d32fe7e00ebd5p-2},
    {0x1.43a2730abee4dp-1, 0x1.d5b7f9ae2c684p-2},
    {0x1.42d6625d51f87p-1, 0x1.d83e7258a2f3ep-2},
    {0x1.420b5265e5951p-1, 0x1.dac353e2c5954p-2},
    {0x1.4141414141414p-1, 0x1.dd46a04c1c4a1p-2},
    {0x1.40782d10e6566p-1, 0x1.dfc859906d5b5p-2},
    {0x1.3fb013fb013fbp-1, 0x1.e24881a7c6c26p-2},
    {0x1.3ee8f42a5af07p-1, 0x1.e4c71a8687704p-2},
    {0x1.3e22cbce4a902p-1, 0x1.e744261d68788p-2},
    {0x1.3d5d991aa75c6p-1, 0x1.e9bfa659861f5p-2},
    {0x1.3c995a47babe7p-1, 0x1.ec399d2468cc0p-2},
    {0x1.3bd60d9232955p-1, 0x1.eeb20c640ddf4p-2},
    {0x1.3b13b13b13b14p-1, 0x1.f128f5faf06edp-2},
    {0x1.3a524387ac822p-1, 0x1.f39e5bc811e5cp-2},
    {0x1.3991c2c187f63p-1, 0x1.f6123fa7028acp-2},
    {0x1.38d22d366088ep-1, 0x1.f884a36fe9ec2p-2},
    {0x1.3813813813814p-1, 0x1.faf588f78f31fp-2},
    {0x1.3755bd1c945eep-1, 0x1.fd64f20f61572p-2},
    {0x1.3698df3de0748p-1, 0x1.ffd2e0857f498p-2},
    {0x1.35dce5f9f2af8p-1, 0x1.011fab125ff8ap-1},
    {0x1.3521cfb2b78c1p-1, 0x1.02552a5a5d0ffp-1},
    {0x1.34679ace01346p-1, 0x1.0389eefce633bp-1},
    {0x1.33ae45b57bcb2p-1, 0x1.04bdf9da926d2p-1},
    {0x1.32f5ced6a1dfap-1, 0x1.05f14bd26459cp-1},
    {0x1.323e34a2b10bfp-1, 0x1.0723e5c1cdf40p-1},
    {0x1.3187758e9ebb6p-1, 0x1.0855c884b450ep-1},
    {0x1.30d190130d190p-1, 0x1.0986f4f573521p-1},
    {0x1.301c82ac40260p-1, 0x1.0ab76bece14d2p-1},
    {0x1.2f684bda12f68p-1, 0x1.0be72e4252a83p-1},
    {0x1.2eb4ea1fed14bp-1, 0x1.0d163ccb9d6b8p-1},
    {0x1.2e025c04b8097p-1, 0x1.0e44985d1cc8cp-1},
    {0x1.2d50a012d50a0p-1, 0x1.0f7241c9b497dp-1},
    {0x1.2c9fb4d812ca0p-1, 0x1.109f39e2d4c97p-1},
    {0x1.2bef98e5a3711p-1, 0x1.11cb81787ccf8p-1},
    {0x1.2b404ad012b40p-1, 0x1.12f719593efbcp-1},
    {0x1.2a91c92f3c105p-1, 0x1.1422025243d45p-1},
    {0x1.29e4129e4129ep-1, 0x1.154c3d2f4d5eap-1},
    {0x1.293725bb804a5p-1, 0x1.1675cababa60ep-1},
    {0x1.288b01288b013p-1, 0x1.179eabbd899a1p-1},
    {0x1.27dfa38a1ce4dp-1, 0x1.18c6e0ff5cf06p-1},
    {0x1.27350b8812735p-1, 0x1.19ee6b467c96fp-1},
    {0x1.268b37cd60127p-1, 0x1.1b154b57da29fp-1},
    {0x1.25e22708092f1p-1, 0x1.1c3b81f713c25p-1},
    {0x1.2539d7e9177b2p-1, 0x1.1d610fe677003p-1},
    {0x1.2492492492492p-1, 0x1.1e85f5e7040d0p-1},
    {0x1.23eb79717605bp-1, 0x1.1faa34b87094cp-1},
    {0x1.23456789abcdfp-1, 0x1.20cdcd192ab6ep-1},
    {0x1.22a0122a0122ap-1, 0x1.21f0bfc65beecp-1},
    {0x1.21fb78121fb78p-1, 0x1.23130d7bebf43p-1},
    {0x1.21579804855e6p-1, 0x1.2434b6f483934p-1},
    {0x1.20b470c67c0d9p-1, 0x1.2555bce98f7cbp-1},
    {0x1.2012012012012p-1, 0x1.26762013430e0p-1},
    {0x1.1f7047dc11f70p-1, 0x1.2795e1289b11bp-1},
    {0x1.1ecf43c7fb84cp-1, 0x1.28b500df60783p-1},
    {0x1.1e2ef3b3fb874p-1, 0x1.29d37fec2b08bp-1},
    {0x1.1d8f5672e4abdp-1, 0x1.2af15f02640adp-1},
    {0x1.1cf06ada2811dp-1, 0x1.2c0e9ed448e8cp-1},
    {0x1.1c522fc1ce059p-1, 0x1.2d2b4012edc9ep-1},
    {0x1.1bb4a4046ed29p-1, 0x1.2e47436e40268p-1},
    {0x1.1b17c67f2bae3p-1, 0x1.2f62a99509546p-1},
    {0x1.1a7b9611a7b96p-1, 0x1.307d7334f10bep-1},
    {0x1.19e0119e0119ep-1, 0x1.3197a0fa7fe6ap-1},
    {0x1.19453808ca29cp-1, 0x1.32b1339121d71p-1},
    {0x1.18ab083902bdbp-1, 0x1.33ca2ba328995p-1},
    {0x1.1811811811812p-1, 0x1.34e289d9ce1d3p-1},
    {0x1.1778a191bd684p-1, 0x1.35fa4edd36ea0p-1},
    {0x1.16e0689427379p-1, 0x1.37117b54747b6p-1},
    {0x1.1648d50fc3201p-1, 0x1.38280fe58797fp-1},
    {0x1.15b1e5f75270dp-1, 0x1.393e0d3562a1ap-1},
    {0x1.151b9a3fdd5c9p-1, 0x1.3a5373e7ebdfap-1},
    {0x1.1485f0e0acd3bp-1, 0x1.3b68449fffc23p-1},
    {0x1.13f0e8d344724p-1, 0x1.3c7c7fff73206p-1},
    {0x1.135c81135c811p-1, 0x1.3d9026a7156fbp-1},
    {0x1.12c8b89edc0acp-1, 0x1.3ea33936b2f5cp-1},
    {0x1.12358e75d3033p-1, 0x1.3fb5b84d16f42p-1},
    {0x1.11a3019a74826p-1, 0x1.40c7a4880dce9p-1},
    {0x1.1111111111111p-1, 0x1.41d8fe84672aep-1},
    {0x1.107fbbe011080p-1, 0x1.42e9c6ddf80bfp-1},
    {0x1.0fef010fef011p-1, 0x1.43f9fe2f9ce67p-1},
    {0x1.0f5edfab325a2p-1, 0x1.4509a5133bb0ap-1},
    {0x1.0ecf56be69c90p-1, 0x1.4618bc21c5ec2p-1},
    {0x1.0e40655826011p-1, 0x1.472743f33aaadp-1},
    {0x1.0db20a88f4696p-1, 0x1.48353d1ea88dfp-1},
    {0x1.0d24456359e3ap-1, 0x1.4942a83a2fc07p-1},
    {0x1.0c9714fbcda3bp-1, 0x1.4a4f85db03ebbp-1},
    {0x1.0c0a7868b4171p-1, 0x1.4b5bd6956e274p-1},
    {0x1.0b7e6ec259dc8p-1, 0x1.4c679afccee3ap-1},
    {0x1.0af2f722eecb5p-1, 0x1.4d72d3a39fd00p-1},
    {0x1.0a6810a6810a7p-1, 0x1.4e7d811b75bb1p-1},
    {0x1.09ddba6af8360p-1, 0x1.4f87a3f5026e9p-1},
    {0x1.0953f39010954p-1, 0x1.50913cc01686bp-1},
    {0x1.08cabb37565e2p-1, 0x1.519a4c0ba3446p-1},
    {0x1.0842108421084p-1, 0x1.52a2d265bc5abp-1},
    {0x1.07b9f29b8eae2p-1, 0x1.53aad05b99b7dp-1},
    {0x1.073260a47f7c6p-1, 0x1.54b2467999498p-1},
    {0x1.06ab59c7912fbp-1, 0x1.55b9354b40bcdp-1},
    {0x1.0624dd2f1a9fcp-1, 0x1.56bf9d5b3f399p-1},
    {0x1.059eea0727586p-1, 0x1.57c57f336f191p-1},
    {0x1.05197f7d73404p-1, 0x1.58cadb5cd7989p-1},
    {0x1.04949cc1664c5p-1, 0x1.59cfb25fae87ep-1},
    {0x1.0410410410410p-1, 0x1.5ad404c359f2dp-1},
    {0x1.038c6b78247fcp-1, 0x1.5bd7d30e71c73p-1},
    {0x1.03091b51f5e1ap-1, 0x1.5cdb1dc6c1765p-1},
    {0x1.02864fc7729e9p-1, 0x1.5ddde57149923p-1},
    {0x1.0204081020408p-1, 0x1.5ee02a9241675p-1},
    {0x1.0182436517a37p-1, 0x1.5fe1edad18919p-1},
    {0x1.0101010101010p-1, 0x1.60e32f44788d9p-1},
    {0x1.0080402010080p-1, 0x1.61e3efda46467p-1},
    {0x1.0000000000000p-1, 0x1.62e42fefa39efp-1},
};
constexpr double kLn2 = 0x1.62e42fefa39efp-1;

struct Paths {
  int count;   // J, fields per key
  int len;     // L, folds per field after the index (padded with -1)
  int data[kMaxFolds];
};

__device__ __forceinline__ void rounds(uint32_t& x1, uint32_t& x2, int a, int b, int c, int d) {
  x1 += x2; x2 = __funnelshift_l(x2, x2, a); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, b); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, c); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, d); x2 ^= x1;
}

// Threefry-2x32, 20 rounds, JAX's schedule: (x1, x2) <- hash of (x1, x2).
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x1, uint32_t& x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1; x2 += k2;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k2; x2 += k3 + 1u;
  rounds(x1, x2, 17, 29, 16, 24); x1 += k3; x2 += k1 + 2u;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k1; x2 += k2 + 3u;
  rounds(x1, x2, 17, 29, 16, 24); x1 += k2; x2 += k3 + 4u;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k3; x2 += k1 + 5u;
}

// The key of field (p, j): keys[p] folded with index[p] (if given), then
// with path j's folds (-1: padding).
__device__ __forceinline__ void field_key(const int32_t* keys, const int32_t* index,
                                          const Paths& paths, int p_key, int p_index, int j,
                                          uint32_t& k1, uint32_t& k2) {
  k1 = static_cast<uint32_t>(keys[2 * p_key]);
  k2 = static_cast<uint32_t>(keys[2 * p_key + 1]);
  for (int l = -1; l < paths.len; ++l) {
    const int d = l < 0 ? 0 : paths.data[j * paths.len + l];
    if ((l < 0 && index == nullptr) || d < 0) continue;   // no index; padding
    uint32_t x1 = 0u;
    uint32_t x2 = static_cast<uint32_t>(l < 0 ? index[p_index] : d);
    threefry(k1, k2, x1, x2);
    k1 = x1;
    k2 = x2;
  }
}

// The log table into shared memory. The caller syncs.
__device__ __forceinline__ void stage_log_table(double2* table) {
  for (int j = threadIdx.x; j <= kLogTable; j += blockDim.x) table[j] = kLogCentre[j];
}

// utils/prng.py::log_f32 of N values: x = 2^e m, m in [1, 2), c_j = 1 +
// j/256 the centre nearest m (m's top 8 fraction bits rounded; a carry
// gives c_256 = 2), log(x) = e ln2 + log(c_j) + log1p(r), r = (m - c_j)(1/
// c_j), in float64, rounded to float32 at the end. Each step runs over the
// N values before the next (no branch), so the N dependent chains
// interleave. out may be x.
template <int N>
__device__ __forceinline__ void log_f32_n(const float (&x)[N], float (&out)[N],
                                          const double2* table) {
  int e[N], j[N];
  double r[N], q[N];
  double2 t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double xd = static_cast<double>(x[k]);
    const int hi = __double2hiint(xd);
    const int m_hi = (hi & 0xFFFFF) | 0x3FF00000;
    const int c_hi = (m_hi + 0x800) & ~0xFFF;
    // The exponent e as e ^ INT_MIN (= e + 2^31 mod 2^32; see below).
    e[k] = static_cast<int>(static_cast<uint32_t>(hi >> 20) + 0x7FFFFC01u);
    j[k] = (c_hi - 0x3FF00000) >> 12;
    r[k] = __dsub_rn(__hiloint2double(m_hi, __double2loint(xd)), __hiloint2double(c_hi, 0));
  }
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = table[j[k]];
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = __dmul_rn(r[k], t[k].x);
  // log1p(r) = r + r^2 q(r), q's coefficients from the highest: -1/6, 1/5,
  // -1/4, 1/3, -1/2 (utils/prng.py::LOG1P_TERMS).
#pragma unroll
  for (int k = 0; k < N; ++k) q[k] = -0x1.5555555555555p-3;
#pragma unroll
  for (int k = 0; k < N; ++k) q[k] = __dadd_rn(__dmul_rn(q[k], r[k]), 0x1.999999999999ap-3);
#pragma unroll
  for (int k = 0; k < N; ++k) q[k] = __dadd_rn(__dmul_rn(q[k], r[k]), -0x1.0000000000000p-2);
#pragma unroll
  for (int k = 0; k < N; ++k) q[k] = __dadd_rn(__dmul_rn(q[k], r[k]), 0x1.5555555555555p-2);
#pragma unroll
  for (int k = 0; k < N; ++k) q[k] = __dadd_rn(__dmul_rn(q[k], r[k]), -0x1.0000000000000p-1);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double log1p = __dadd_rn(__dmul_rn(__dmul_rn(r[k], r[k]), q[k]), r[k]);
    // e as a double without a conversion: 2^52 + 2^31 + e, exact, less
    // 2^52 + 2^31.
    const double ed = __dsub_rn(__hiloint2double(0x43300000, e[k]), 0x1.0000080000000p52);
    out[k] = __double2float_rn(__dadd_rn(__dadd_rn(__dmul_rn(ed, kLn2), t[k].y), log1p));
  }
}

// jax.random.gumbel's values of N x 32 random bits: u = max(tiny, f * (1 -
// tiny) + tiny) with f = [1, 2) from the top 23 bits, minus 1 (1 - tiny is
// 1 in float32), then -log(-log(u)): the N inner logs, then the N outer.
template <int N>
__device__ __forceinline__ void gumbel_n(const uint32_t (&bits)[N], float (&g)[N],
                                         const double2* table) {
  const float tiny = 0x1.0p-126f;
  float u[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float f = __fsub_rn(__uint_as_float((bits[k] >> 9) | 0x3F800000u), 1.0f);
    u[k] = fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f), tiny));
  }
  log_f32_n(u, g, table);
#pragma unroll
  for (int k = 0; k < N; ++k) g[k] = -g[k];
  log_f32_n(g, g, table);
#pragma unroll
  for (int k = 0; k < N; ++k) g[k] = -g[k];
}

struct Draw {
  int P, J, R, M;   // keys, paths, rows per field (prod(shape)), logits per row
  int key_rows, index_rows, logit_rows;   // rows of each input; row p takes p % rows
};

// (s, i) beats (bs, bi): torch.argmax's order, NaN above every number and
// the first index on ties.
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  const bool sn = s != s, bn = bs != bs;
  if (sn || bn) return sn && (!bn || i < bi);
  return s > bs || (s == bs && i < bi);
}

// Wpr warps own a row (1, or 2 where the call has too few rows to fill
// the card); a block holds kWarps / Wpr rows.
template <int Wpr>
__global__ void __launch_bounds__(kWarps * 32)
threefry_categorical_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ index,
                            const float* __restrict__ logits, Paths paths, Draw d,
                            int64_t* __restrict__ out) {
  constexpr int kRows = kWarps / Wpr, kStride = 32 * Wpr;
  __shared__ double2 table[kLogTable + 1];
  __shared__ uint32_t field_keys[kRows][2];
  __shared__ float part_score[kWarps];
  __shared__ int part_index[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp % Wpr, first = part * 32 + lane;
  const int total = d.P * d.J * d.R;
  const int row0 = blockIdx.x * kRows;
  const int field0 = row0 / d.R;
  const int row = row0 + warp / Wpr;
  const int field = min(row, total - 1) / d.R;
  const float* lg = logits + static_cast<int64_t>((field / d.J) % d.logit_rows) * d.M;
  // The first logits in flight beside the table, the keys and the barrier;
  // each round loads the next round's.
  float logit[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) logit[c] = __ldg(lg + min(first + c * kStride, d.M - 1));
  stage_log_table(table);
  if (threadIdx.x < kRows) {   // the block's fields, one thread each
    const int f = field0 + threadIdx.x;
    if (f <= (min(row0 + kRows, total) - 1) / d.R) {
      const int p = f / d.J;
      field_key(keys, index, paths, p % d.key_rows, p % d.index_rows, f - p * d.J,
                field_keys[threadIdx.x][0], field_keys[threadIdx.x][1]);
    }
  }
  __syncthreads();
  // A lane's values come in increasing m: it keeps the first of equal
  // scores by taking only a larger one (or the first NaN, as torch.argmax),
  // its first value's index standing for a run of -inf.
  float best = -INFINITY;
  int best_index = row < total && first < d.M ? first : INT_MAX;
  if (row < total) {
    const uint32_t k1 = field_keys[field - field0][0], k2 = field_keys[field - field0][1];
    const uint32_t base = static_cast<uint32_t>(row - field * d.R) * static_cast<uint32_t>(d.M);
    for (int m0 = first; m0 < d.M; m0 += kStride * kChains) {
      // Branch-free up to the maximum, so that the chains interleave: a
      // counter past M is hashed too and its score dropped.
      uint32_t bits[kChains];
      float g[kChains], next[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        next[c] = __ldg(lg + min(m0 + (kChains + c) * kStride, d.M - 1));
        uint32_t x1 = 0u, x2 = base + static_cast<uint32_t>(m0 + c * kStride);
        threefry(k1, k2, x1, x2);
        bits[c] = x1 ^ x2;
      }
      gumbel_n(bits, g, table);
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const int m = m0 + c * kStride;
        const float s = __fadd_rn(g[c], logit[c]);
        if (m < d.M && !(s <= best) && best == best) {
          best = s;
          best_index = m;
        }
        logit[c] = next[c];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int i = __shfl_xor_sync(0xFFFFFFFFu, best_index, off);
    if (beats(s, i, best, best_index)) {
      best = s;
      best_index = i;
    }
  }
  if constexpr (Wpr > 1) {   // the row's warps merge in shared memory
    if (lane == 0) {
      part_score[warp] = best;
      part_index[warp] = best_index;
    }
    __syncthreads();
    if (lane == 0 && part == 0)
      for (int w = 1; w < Wpr; ++w)
        if (beats(part_score[warp + w], part_index[warp + w], best, best_index)) {
          best = part_score[warp + w];
          best_index = part_index[warp + w];
        }
  }
  if (lane == 0 && part == 0 && row < total) out[row] = best_index;
}

bool make_paths(int J, int L, const int* path, Paths& paths) {
  if (J < 1 || L < 0 || J * L > kMaxFolds) return false;
  paths = Paths{};
  paths.count = J;
  paths.len = L;
  for (int i = 0; i < J * L; ++i) paths.data[i] = path[i];
  return true;
}

}  // namespace

// out (P, J, R) int64 indices from keys (key_rows, 2) int32, index
// (index_rows,) int32 or null, logits (logit_rows, M) float32 (row p of the
// draw takes row p % rows of each; each count divides P), J paths of L
// folds each (path, J x L values, -1 where a shorter path has no fold), R
// draws per field (prod(shape)). Returns the
// launch's cudaError_t (0 on success).
extern "C" int threefry_categorical(const void* keys, int key_rows, const void* index,
                                    int index_rows, const void* logits, int logit_rows, int P,
                                    int J, int L, const int* path, int R, int M, void* out,
                                    void* stream) {
  Paths paths;
  const int64_t rows = static_cast<int64_t>(P) * J * R;
  if (P < 1 || !make_paths(J, L, path, paths) || R < 1 || M < 1 ||
      static_cast<int64_t>(R) * M >= (int64_t{1} << 31) || rows >= (int64_t{1} << 31) ||
      key_rows < 1 || P % key_rows || logit_rows < 1 || P % logit_rows ||
      (index != nullptr && (index_rows < 1 || P % index_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Draw d{P, J, R, M, key_rows, index == nullptr ? 1 : index_rows, logit_rows};
  // Two warps a row where one a row would leave the card under half its
  // kTargetWarps (the main path's 1,024-row calls on an H100: 8.75 against
  // 10.28 us, PERF.md).
  auto* kernel = rows * 2 <= kTargetWarps ? threefry_categorical_kernel<2>
                                          : threefry_categorical_kernel<1>;
  const int per_block = rows * 2 <= kTargetWarps ? kWarps / 2 : kWarps;
  const int blocks = static_cast<int>((rows + per_block - 1) / per_block);
  kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(index),
      static_cast<const float*>(logits), paths, d, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
