"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit from nvidia-smi.
2. Build: nvcc compiles the MSDA forward and backward kernels from
   semi_detr_tpu_torch/csrc, one nvcc per source started together (timed;
   ptxas register report printed), and g++ the host library from
   semi_detr_tpu_torch/native at the same time (timed; phases 4-7 use its
   resize, decode and augmentation ops), the serving runner
   (csrc/serve_main.cpp) and, once the forward kernel's library is built,
   the MSDA operator library that links it (csrc/msda_op.cpp), both
   against libtorch (timed; phase 9b runs them).
3. Kernel against its plain version, at the main path's shapes (encoder
   Lq = S = 22,323 and decoder Lq = 900, N=1, M=8, D=32, L=4, P=4) and on
   an out-of-bounds case, each in float32 (TF32 off) and bfloat16: max abs
   error against the stated tolerance, the kernel instance taken (channels
   per lane: 16 bytes of the dtype, or 1), kernel ms, plain ms, the bound
   (the least time the card could take for the same work) and the rate of
   gathered value rows. The float32 encoder and decoder outputs must equal
   the plain version's to the bit: the float32 forward sums in the order
   of torch's reduction, so a torch that reduces otherwise fails here, at
   the cause (phase 5b's decoder limit, set from its own sub-rounding
   witness, no longer depends on that order).
4. Main path: `init_detector` at full width (DINO-R50, the
   configs/dino_detr/dino_detr_r50_coco.py model, bfloat16, seeded
   weights) on the card serves synthetic uint8 requests of odd landscape
   and portrait sizes through `Predictor.__call__`, with the top-k and the
   NMS decode. The last layers of the box MLPs (zero in the seeded init)
   are filled from a seed, so the boxes go through the decoder's
   refinement. Each answer has 300 detections of finite score with boxes
   inside the image, and the MSDA kernel launches exactly 12 times per
   forward, every time through its vector instance. Warm per-request
   latency and images/s are printed. Then one request runs in float32
   (TF32 off) through the kernel and through the plain version, and the
   two are compared within tolerance (the float32 kernel sums in the plain
   version's order, so they may agree to the bit); the coordinates must
   move when the decoder's MSDA output moves.
3b. Backward kernel against its plain version (autograd through the plain
   forward), at the training step's shapes (batch 2: encoder Lq = S =
   22,323, decoder Lq = 900 + 200 CDN slots = 1,100) and on an
   out-of-bounds/NaN/lower-edge case, each in float32 (TF32 off) and
   bfloat16: the max abs error of d_value, d_loc and d_attn against
   tolerances scaled to each output's magnitude, the instance taken,
   kernel ms, plain ms, the bound, the rate of gathered value rows, and the
   backward of the grid_sample composite as a yardstick.
5. Training path: the supervised step at full width (`init_train_state`
   of the config above: bfloat16 compute, float32 parameters, seeded
   weights, the config's optimizer, EMA teacher), batch 2 per step,
   `synthetic_batch`'s seeded uint8 images through `pack` and `stack` in
   both bucket orientations, seeded GT counts including an
   image with 0 GT (fake CDN) and one with 100: 2 warm-up steps (O2M +
   task-aligned focal loss), then 3 Hungarian steps. Every loss and the
   grad norm finite, every trainable parameter moved, the frozen stem and
   layer1 unchanged bit for bit, and exactly 12 MSDA forward and 12
   backward launches per step, every one through the vector instances.
   Step times, images/s and the peak device memory are printed.
5b. Both kernels inside the model, float32 (TF32 off), one 599x401 image:
   the parameter gradients of a seeded projection of the encoder memory
   through the kernels and through the plain versions; then each kernel
   alone (forward kernel with the plain backward, and the backward kernel
   under either forward), the kernels twice (the noise floor of the
   atomic scatter) and the plain version with its output moved by one
   float32 rounding (how far the model carries a rounding of the forward);
   then the decoder's hs, both runs decoding one shared encoder output,
   with the same witnesses. Each leaf within a relative L2 tolerance; the
   decoder's, DECODER_WITNESS_FACTOR times its sub-rounding witness's worst
   leaf in this call, printed beside the reading.

6. SSOD path: the Semi-DETR teacher-student step at full width
   (`init_ssod_state` of configs/detr_ssod/semi_detr_r50_coco_120k.py:
   DINO-R50, 900 queries, CDN budget 200, max_pseudo 32, 5 consistency
   groups, bfloat16 compute, float32 parameters, seeded weights with the
   box MLPs' last layers filled), 1 supervised + 4 unlabeled 800x1344
   images from `synthetic_ssod_batch`, the student view the teacher view
   flipped: 5 warm-up steps (the second at score_thr 0, so the supervision
   set is not empty), then 4 Hungarian steps; the warm step time is the
   median of the last three of each stage. Each step: every loss finite;
   48 (warm-up) or 42 forward and 24 backward MSDA launches, all through the
   vector instances; the projector moved (after the warm-up on a zero
   gradient); the frozen stem and layer1 unchanged bit for bit; the teacher
   moved by the EMA. Step ms, images/s, peak memory, the pseudo-label,
   supervision-set and consistency-set sizes and gmm_thr are printed.
   Phases 3 and 3b also hold both kernels at this path's new shapes (N=4
   encoder; decoder Lq 1,260 = 160 consistency + 200 CDN + 900, N=4), in
   bfloat16.
7a. Host library on the card: what the build probe found (g++, CPU
   architecture, zlib, libjpeg, nvJPEG), the JPEG route and `decoders()`.
   The committed fixtures (native/fixtures: a 4:2:0 colour JPEG of odd
   size, a grayscale one, and a progressive 4:2:0 one) decode to their
   committed libjpeg pixels exactly on either route (sequential and
   progressive streams take the host library's decoders where the back
   end is nvJPEG; `decoders()` names the routes), and the back end's own
   decode
   within NVJPEG_TOL on the nvJPEG route; ms per image of both. The
   fixtures of every other kind the JAX package reads (native/fixtures/
   jpeg_formats.json: 4:1:1, 4:4:0, Adobe RGB, arithmetic sequential and
   progressive, a progressive script cut after 3 scans (smoothed), CMYK,
   YCCK; png_*.png: 1-, 2- and 4-bit gray, a 2-bit palette with tRNS,
   16-bit RGBA, Adam7 RGB) decode through the host decoders to their
   committed pixels (libjpeg's, libpng's, cv2's for CMYK and YCCK) at
   max abs 0, each with its kind, route and ms; nvJPEG's decode of each
   JPEG fixture is printed beside it (or its refusal). The
   library's JPEG encode + decode of both fixture pictures and a 480x640
   noise picture against cv2's quality-95 round trip of each (committed in
   native/fixtures/cv2_q95_roundtrip.json): equal on the libjpeg route,
   within ROUND_TRIP_SLACK on the nvJPEG route. A truncated copy of the
   colour fixture and one with a bad Huffman code, a truncated arithmetic
   fixture and a PNG fixture with a damaged chunk raise ImageDecodeError
   naming the file. The fixtures of the files the JAX loader hands to cv2
   (native/fixtures/formats.json: BMP of every header, depth and RLE, PNM
   P1-P6, TIFF of every compression, layout and photometric the library
   reads (CCITT, BigTIFF, CMYK, YCbCr, signed samples among them; tiffx_*:
   orientation 5-8 on square pictures, StripByteCounts libtiff estimates
   anew, CMYK inside JPEG, a predictor on subsampled YCbCr, CIELab, SGILog
   and ThunderScan, and a 480x640 CIELab file), WebP
   lossless, lossy, with alpha, turned by EXIF and animated, lossless JPEG,
   GIF, Sun raster, PAM, PFM, Radiance HDR and JPEG 2000 (JP2 and raw
   codestreams: both wavelets, every progression, POC, tiles, precincts,
   every code-block style, layers, RGN, PPM / PPT, SOP / EPH, palettes,
   channel definitions, colour specifications; j2kh_*: high-throughput
   code-blocks, the cleanup pass alone and with SigProp and MagRef,
   layers, lossy cleanups, 9/7, VSC, 4x4 to 64x64 blocks, tiles, gray,
   12- and 16-bit, RGBA, JP2, JPH and raw codestreams, with their ms and
   the ms of a 480x640 HT file); a 480x640 lossy WebP,
   lossless WebP, LZW TIFF, Group 4 TIFF, GIF, HDR and JPEG 2000 (5/3 and
   9/7), and a 480x640 Sun
   raster, PAM and PFM written from a cv2 reference by
   `tools.raw_formats`, for times at a real size) decode on the card to
   their stored cv2 pixels at max abs 0, each with its format, variant,
   route and ms, and ms per format; what cv2 refuses (12-bit and some
   lossless JPEG, TIFF orientation 6 on a picture that is not square,
   LZMA, ZSTD and float TIFF, TIFF predictor 3 on integer samples, ICC
   CIELab, LogLuv without SGILog, RLE Sun raster, signed, sub-sampled or
   offset JPEG 2000, the mixed HT style, ROI or more than 3 passes in an
   HT code-block, ...) raises saying so; avif_*: lossless AVIF at 8, 10
   and 12 bits, monochrome, speeds 0-9, screen content (palette, intra
   block copy), edge sizes, the alpha item, iloc versions 0-2 and idat,
   irot / imir / clap, ICC, a grid, a full sequence header, and lossy
   AVIF as cv2.imwrite writes it (avif_lossy_*, other_avif: 4:2:0 BT.601
   full range and monochrome, 8-12 bits, qualities 0-99, speeds 0-10:
   quantizer matrices, delta q, every transform size and intra type,
   deblocking, CDEF, loop restoration, intra block copy with its transform
   trees, libyuv's bilinear chroma), and what other writers and sizes give
   (avif_tiles_*: Pillow's 2x2 tiles, cv2's 2x1 at 300x4200 and 256x4104;
   avif_layout_*: Pillow's lossy 4:4:4 and 4:2:2 with CDEF, loop
   restoration, palette and intra block copy, lossless 4:2:0 and 4:2:2;
   avif_colr_*: limited range, BT.709, BT.2020, unspecified and
   chromaticity-derived matrices), each at
   max abs 0, with the AV1 tool tally (every tool reached) and the
   480x640 lossless and lossy files' and the several-tile files' decode ms
   on one core beside the card's name and power limit; and
   damaged copies of each format (an HT file cut in half and one whose
   Scup runs past its cleanup segment among them)
   raise naming the file, but a TIFF of LZW codes garbled inside a strip,
   which cv2 reads to a picture (libtiff's RGBA reader goes on with what
   the codec wrote) and so does the library; the TIFF fixtures of the compressions cv2's
   libtiff cannot decode (Pixar, NeXT, JPEG 2000 inside TIFF) read as the
   one-colour picture of zero samples, as cv2 reads them. The library's
   JPEG 2000 encoder (OpenJPEG 2.5.3's reversible encoder at cv2's rate 4)
   writes cv2's bytes on this machine's compiler: the committed pictures
   (native/fixtures/jp2w_*.png) against cv2's committed .jp2 files, and
   480x640 and 800x1344 pictures against the length and sha256 of cv2's
   files (jp2_writes.json), with encode and decode ms; below 32 pixels
   it refuses as cv2 does, leaving cv2's 77 bytes. The library's AVIF
   encoder (cv2.imwrite's defaults: cv2's boxes, sequence header and
   quantizer, the library's own tile) writes, on this machine's compiler,
   the bytes the sandbox's compiler wrote for each picture of
   avif_writes.json (host_picture at 480x640, 800x1344, 1x1, 2x3, 45x61
   and 65x129, the jp2w_*.png pictures, a render.json render: length and
   sha256), each read back by the library's decoder to the committed
   decode's sha256; encode ms of each (the 480x640 and 800x1344 ones
   printed beside the card's name and power limit); and a 256x4104
   picture, written in 2x1 tiles, read back to the encoder's
   reconstruction, with its encode and decode ms. Every
   op equals its numpy plain version bit for bit on this host: a 480x640
   source resized to all 11 COCO scales, the six warps (translate x / y,
   rotate +-30, shear x / y) at 800x1066, the 81 colour op x magnitude
   cases at 800x1066, the PNG row filters; ms per op for C++ and numpy,
   and JPEG / PNG encode and decode ms at 480x640 (and the JPEG check alone).
7. Trainer path, in a temporary directory removed at the end: the port's
   `write_synthetic_coco` writes 8 labelled, 16 unlabelled and 8 val JPEG
   images of 480x640 through the host library (up to 3 boxes and 2
   distractors each, one class, which the annotation files name after
   data.classes[0]), and phase 7a's fixtures of the other
   kinds (JPEG and PNG, and one BMP, PNM, TIFF, WebP, lossless JPEG, GIF,
   HDR, JP2 (9/7), raw JPEG 2000 codestream (5/3) and 480x640 lossless
   and lossy AVIF of the cv2 formats)
   join the unlabelled and val images, without
   boxes, so
   the trainer (load_image) and its evals (the prefetch loader) read them;
   the SSOD CLI
   (`tools.train_detr_ssod.main`, in-process) runs
   configs/detr_ssod/semi_detr_r50_coco_120k.py at full width (80 classes,
   1 + 4 images at 800x1344, the 11 COCO scales, bfloat16) from those files,
   with data.classes the 80 COCO names of which 16 (index 0 among them)
   are replaced by the names of phase 7r's case "names" (Rubik past ASCII,
   the fallback font, the box), and ssod.score_thr 0 (with random weights
   the recipe's 0.4 keeps no pseudo label to draw), so the pseudo renders
   draw labels through the trainer's own path (printed: their labels by
   route; at least one asserted),
   for 8 steps, with warm_up_step, eval and render intervals of 4 and a
   checkpoint at the end. Asserted: steps 0-7 ran (4 in the warm-up); 48 /
   42 forward and 24 backward MSDA launches per step and 12 forward per
   eval batch (teacher and student), all through the vector instances;
   checkpoint 8 on disk; Eval[teacher] and Eval[student] lines with every AP in
   [0, 1] (NaN only for the small and medium ranges, which hold no GT);
   a finite total_loss at step 0 in metrics.jsonl; the pseudo renders.
   Then the CLI runs again to step 9: "resumed from step 8", one step. The
   eval CLI (`tools.test.main`) scores the last checkpoint's teacher; the
   supervised CLI (`tools.train_detr_od.main`) takes 2 steps of batch 2
   (the config says 16) with 12 + 12 launches each. Printed: warm step ms
   (median of steps 1-3 and of 5-7) beside phase 6's bare step of this
   call and beside the same steps (3 warm-up, 3 Hungarian) on the
   trainer's next batches built beforehand (no prefetch thread running), train.data_wait ms per step,
   augmentation ms per weak and strong view through the host library and
   through the numpy plain versions, decode ms per image, eval ms per
   image, checkpoint save s and bytes, peak memory. Phase 3 also holds the
   forward kernel at the eval batch's decoder shape (N=4, Lq 900,
   bfloat16). The pseudo-label renders are `pseudo_vis/step_N.jpg`.
7r. The render on the card's host (no cv2 there): `api.save_result` on
   the committed cases (native/fixtures/render.json: seeded pictures,
   all 80 COCO names, scores 0.00-1.00, labels clipped at the top, left
   and right edges; and the case "names", whose class list takes every
   route of utils.text: Rubik past ASCII, the fallback font WenQuanYi
   Micro Hei, the box, a line break and an end of text) against cv2 5.0's
   renders of them (the JAX save_result's, committed as PNG), by
   `tools.render_check`: box pixels at max abs 0, label pixels at an ink
   IoU of at least IOU_FLOOR and a mean abs of at most MEAN_ABS_CEIL (their
   equal share and max abs printed); the case "names" must equal its PNG
   exactly; then the
   image demo (`tools.image_demo.main`, --score-thr 0) on JPEG, BMP, PPM,
   TIFF (LZW RGB and a 480x640 CIELab file), WebP, PGM, PFM, Sun raster,
   PAM, HDR, GIF, JPEG 2000 (a 480x640 .jp2, and a 480x640 .jp2 of
   high-throughput code-blocks) and AVIF (the 480x640 lossless and lossy
   fixtures, and cv2's 256x4104 file of 2x1 tiles) with phase 7's SSOD
   checkpoint:
   each render
   under its input's name in its input's format (no file for the .pgm, as
   cv2 writes none), reading back to the pixels drawn (the JPEG, HDR, GIF
   and JPEG 2000: the library's encode of them, HDR within HDR_READBACK
   levels, GIF on its table's steps, JPEG 2000 through the library's
   decoder at the render's size; the two .avif renders, written at
   cv2.imwrite's defaults, the library's encode of them read back at the
   render's size, their PSNR against the render printed; the 256x4104
   one's render in 2x1 tiles), 12 forward MSDA launches per image
   (204 in all, 17 inputs) and no backward
   (the `demo` path). Printed: ms per image (save_result, draw and PNG
   write), ms per label and ms per label by route, the fallback font's
   inflate-and-parse ms and the rasterisation ms of the glyphs the cases
   draw (each once per process), the demo's seconds.

8a. Data parallel, two ranks spawned over gloo on the one card (one rank
   per card over NCCL where there are two; `parallel.dist.run_local`, each
   rank joined within DDP_TIMEOUT seconds or killed, every exit code
   checked). The float32 equality run (TF32 off, full-width DINO-R50 of
   the SSOD recipe, phase 6's seeded weights, 1 + 2 images per rank at
   800x1344 from one seeded global batch): a warm-up step at score_thr 0
   and a Hungarian step; rank 0 saves the state before each. One process
   then takes each step on the global batch (2 + 4 images) from that
   state, as do its witnesses: the same with every image value moved by
   one float32 rounding, up and down. The ranks must agree with each other
   exactly (metrics, parameters to the bit); their kept sets and GMM
   element must equal one process's, and each Hungarian solve's columns
   too, or be a near tie held by its matching cost (a witness changes
   that solve as well, and the ranks' assignment on one process's cost
   matrix exceeds its optimum by at most WITNESS_FACTOR times a witness's
   excess, plus hungarian_hold.FLOAT32_FLOOR of the optimum's magnitude);
   each solve is reported equal, near tie (the two excesses) or failed;
   their loss terms,
   grad_norm, gmm_thr and per-leaf update errors must lie within
   WITNESS_FACTOR times the witnesses' largest distance from one process.
   The bfloat16 timing run: the recipe's 1 + 4 images
   per rank, 2 warm-up steps (the first carries the first-call costs) and
   a Hungarian step after them (DDP_TIME_STEPS); per rank the step ms, the
   gradient all-reduce's ms (span `dist.grad_allreduce`, synchronised on
   both sides), the MSDA launches per step (48 / 42 + 24, vector
   instances, asserted) and the peak memory, beside phase 6's one-process
   step. Two processes share the card: no scaling figure.
8b. The SSOD CLI under `python -m torch.distributed.run --standalone
   --nproc-per-node 1` (NCCL, world 1) on phase 7's synthetic JPEG set:
   this script re-enters as the launcher's rank (its TORCHRUN_FLAG
   argument), counts the MSDA launches of each step and eval, and calls
   the CLI's `main`: 2 warm-up and 2 Hungarian steps, eval after step 2,
   a checkpoint at the end. Asserted: the log names backend nccl, rank 0
   wrote the checkpoint, the launches per step equal phase 7's, the eval
   lines hold valid APs.

8c. FSDP, tensor parallelism and donation (`parallel.sharding`), the legs
   run by ranks spawned as 8a's (gloo on the one card; NCCL, one rank per
   card, where the machine has as many cards), one spawn per world size,
   its legs in turn: FSDP at W = 2 then TP at tp = 2 (W = 2, data 1) in
   phase 8a's two ranks, after 8a's runs; FSDP + TP at W = 4 (data 2 x
   model 2) and then the trainer below in four. Each leg runs 8a's
   float32 equality run on its layout (a TP leg its first step only,
   `layout_eq_steps`): the first step against 8a's one process and
   witnesses (the same seeded start), the second against one process from
   the leg's own state within 8a's witness limits; kept sets and
   GMM element equal, Hungarian columns equal or a near tie held as in
   8a; frozen leaves bit-unchanged;
   the teacher moved. Under TP each rank's gradients before the model
   group's broadcast (`dist.align_model_group_`) are held, per leaf, to
   ALIGN_FACTOR times the floor of one process taking the first step twice
   from the same state (the backward's atomic order). Then a bfloat16
   timing run at 8a's batch (LAYOUT_TIME_STEPS: a cold and a warm
   Hungarian step; the warm-up stage is timed in 8a and phase 6): per
   rank the
   step ms, the all-reduce's and the broadcast's
   ms, the MSDA launches (48 / 42 + 24, vector instances, asserted), the
   peak memory per step and the local state bytes (parameters, a gradient
   per trainable parameter, moments, teacher), held to at most
   LAYOUT_STATE_SHARE of 8a's data-parallel rank under FSDP, and the FFN
   pairs split by tp under TP. Donation: every step
   updates in place in chunks of `optim.UPDATE_CHUNK` elements; one EMA
   and optimizer update so from one state and one set of seeded gradients
   against the whole state in one call, in turns: bit-equal, every state
   tensor in its storage, the peak no higher, the ms of each; then a
   whole step keeps the storage. The SSOD CLI with fsdp=True tp=2
   donate=True over the 4 ranks, after their leg, on a synthetic JPEG set
   (2 steps, an eval and a checkpoint at the end), and that checkpoint
   resumed in one process for one step.
   Ranks sharing one card give no scaling figure, and none is claimed.
9. (Run after phase 7; its compiles go on beside phases 8a-11, and 9b
   comes last.) The serving programs exported:
   `tools.export_model.export_program` traces phase 4's detector (full-width DINO-R50, bfloat16, seeded
   weights, box layers filled) with `torch.export` at batch 1: the top-k
   and the NMS decode in the landscape bucket 800x1344 and the top-k in
   the portrait bucket 1344x800 (SERVED), and saves them. A fresh process
   (this script with EXPORT_FLAG, importing only the port) loads the
   landscape ones and runs each on phase 4's packed landscape requests,
   counting the MSDA launches of each run from 0. Asserted: top-k boxes,
   scores and labels equal eager `predict`'s to the bit; the NMS kept sets
   equal; 300 finite detections inside the image; exactly 12 forward
   launches per run, all through the vector instance. Printed: export s,
   artifact bytes, load s, warm ms per request of the loaded program
   beside eager `predict`.
9b. The served program without Python: each program of phase 9, and the
   landscape top-k of the same weights in float32 with its two-stage
   selection given (`SelectionGiven`), compiled by AOTInductor
   (`tools.export_model.package_program`) into packages, one compiling
   process each with PACKAGE_THREADS compile threads, all started as
   phase 9 saves the programs; 9b, after phase 11, waits for them, makes
   the detector again from its seed and times eager `predict`; each
   package run by the same fresh Python process
   (`aoti_load_package`; the Python operator serves MSDA) and each
   bfloat16 one by the C++ runner (`tools.serve_runner`: csrc/
   serve_main.cpp built by g++ in phase 2, no libpython in its `ldd`, an
   emptied environment; the C++ operator library csrc/msda_op.cpp serves
   MSDA). Asserted: 12 MSDA launches per run through the vector instance
   of the program's dtype, counted by each operator; the runner's outputs
   equal the Python-loaded package's to the bit; 300 finite detections
   inside the image; the float32 package (TF32 off, eager's selection)
   equal to float32 eager within FLOAT32_TOL, its encoder memory by
   position and its boxes, scores and labels by rank (a near tie
   excepted); each bfloat16 package's scores in descending order within
   PACKAGE_WITNESS_FACTOR times a witness (eager on the request moved by
   one bfloat16 rounding). Printed: compile s and bytes per package, load
   s, warm ms per request of the package in Python and in the runner
   beside eager `predict` and the torch.export program, one traced pass
   of the top-k package and of eager `predict` (device kernel and busy ms
   per request, busy share), torch's and CUDA's versions; phase 2 prints
   the operator library's and the runner's build s.
10. Remat: phase 6's SSOD step (its state, seeded weights and batch;
   a warm-up step at score_thr 0, then a Hungarian step) and phase 5's
   supervised step (an O2M and a Hungarian step), each run from one state
   REMAT_ROUNDS times in turns without and with remat. Asserted: the loss
   terms bit-equal; the MSDA launches unchanged (48 or 42 + 24, 12 + 12,
   vector instances), so the forward kernel is saved, not replayed; per
   leaf, the gradient and update errors of remat against no remat at the
   atomic-order floor (no remat against no remat, remat against remat):
   the medians at the floor, each leaf within one bfloat16 rounding beyond
   its floor (remat reorders bfloat16 gradient sums); the update leaves
   that Adam's first steps turn to noise held by their ratio of error to
   floor at its 0.9 quantile, within twice the same statistic between runs
   of one mode in this call, and at its median (`tools.remat_check`).
   Printed: those readings beside their witness, the warm step ms with and
   without remat (medians of the runs in turns) and the peak memory.
11. The recipe rehearsal, short: `tools.recipe_rehearsal` at full width
   on a 40-image synthetic set, 8 steps, the warm-up boundary at 4, leg
   1 to step 5, leg 2 resumed to 8, eval every 3 steps, every step
   logged. Asserted: both legs exit 0; leg 2 resumed from leg 1's last
   checkpoint; Eval[teacher] and Eval[student] at steps 3 and 6 with
   valid APs; a finite loss on every step; the report under the work dir;
   each leg's MSDA launches (the trainer's log line) as its steps and
   evals require, all through the vector instances.

The line before the last is a JSON object with the kernels' numbers and the
training records; the last line is {"ok": true, "device": {...}}.
"""
import atexit
import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on the card",
          file=sys.stderr)
    sys.exit(1)

from semi_detr_tpu_torch import native  # noqa: E402
from semi_detr_tpu_torch.api import (  # noqa: E402
    Predictor, init_detector, save_result)
from semi_detr_tpu_torch.data.coco import COCO_CLASSES  # noqa: E402
from semi_detr_tpu_torch.data import augment, image_io  # noqa: E402
from semi_detr_tpu_torch.data.pipeline import (  # noqa: E402
    synthetic_batch, synthetic_ssod_batch, to_device)
from semi_detr_tpu_torch.models import transformer as tr  # noqa: E402
from semi_detr_tpu_torch.models.dino_head import prepare_images  # noqa: E402
from semi_detr_tpu_torch.models.inference import (  # noqa: E402
    decode_topk, predict)
from semi_detr_tpu_torch.ops import hungarian  # noqa: E402
from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as msda  # noqa: E402
from semi_detr_tpu_torch.ops import msda_cpp  # noqa: E402
from semi_detr_tpu_torch.ops.ms_deform_attn import (  # noqa: E402
    ms_deform_attn, ms_deform_attn_backward_autograd)
from semi_detr_tpu_torch.parallel import dist, sharding  # noqa: E402
from semi_detr_tpu_torch.data.synthetic import (  # noqa: E402
    write_synthetic_coco)
from semi_detr_tpu_torch.tools import export_model  # noqa: E402
from semi_detr_tpu_torch.tools import image_demo  # noqa: E402
from semi_detr_tpu_torch.tools import profile_predict  # noqa: E402
from semi_detr_tpu_torch.tools import raw_formats  # noqa: E402
from semi_detr_tpu_torch.tools.raw_formats import (  # noqa: E402
    raw_format_files)
from semi_detr_tpu_torch.tools import recipe_rehearsal  # noqa: E402
from semi_detr_tpu_torch.tools.remat_check import (  # noqa: E402
    check_remat, rel_errors)
from semi_detr_tpu_torch.tools import hungarian_hold  # noqa: E402
from semi_detr_tpu_torch.tools import render_check  # noqa: E402
from semi_detr_tpu_torch.tools import serve_runner  # noqa: E402
from semi_detr_tpu_torch.tools import test as test_cli  # noqa: E402
from semi_detr_tpu_torch.tools import train_detr_od  # noqa: E402
from semi_detr_tpu_torch.tools import train_detr_ssod  # noqa: E402
from semi_detr_tpu_torch.train import checkpoint as ckpt_mod  # noqa: E402
from semi_detr_tpu_torch.train.loop import SsodTrainer  # noqa: E402
from semi_detr_tpu_torch.train import optim  # noqa: E402
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step  # noqa: E402
from semi_detr_tpu_torch.train.state import (  # noqa: E402
    ema_update, init_ssod_state, init_train_state, refine_boxes)
from semi_detr_tpu_torch.train.supervised import (  # noqa: E402
    make_supervised_train_step)
from semi_detr_tpu_torch.utils import logging as port_logging  # noqa: E402
from semi_detr_tpu_torch.utils import text  # noqa: E402
# the yardstick: the main-path levels of the 800x1344 bucket, M = 8,
# D = 32, P = 4, the seeded inputs, the bounds and the timer
from semi_detr_tpu_torch.tools.msda_bench import (  # noqa: E402
    D, M, P, S, SHAPES, bound, bound_bwd, cuda_ms, gathered_bytes,
    msda_inputs, ptxas_summary)

CONFIG = "configs/dino_detr/dino_detr_r50_coco.py"
SSOD_CONFIG = "configs/detr_ssod/semi_detr_r50_coco_120k.py"
# the SSOD recipe's batch: 1 supervised + 4 unlabeled images per card
SSOD_SUP, SSOD_UNSUP, SSOD_BUCKET = 1, 4, (800, 1344)
# the SSOD steps: (warm_up, score_thr override or None for the recipe's);
# the first of each stage carries its first-call costs, the second warm-up
# step checks a non-empty supervision set, and the warm steps (median of
# three per stage, at the recipe's score_thr as the trainer runs them) are
# SSOD_WARM's
SSOD_STEPS = ((True, None), (True, 0.0)) + ((True, None),) * 3 \
    + ((False, None),) * 4
SSOD_WARM = {"warm_up": (2, 3, 4), "hungarian": (6, 7, 8)}
# MSDA launches per SSOD step (forward, backward): sup encoder + decoder,
# teacher encoder + matching decode, student encoder + matching decode +
# training decode, and in warm-up the teacher's consistency decode; 6 each
SSOD_LAUNCHES = {True: (48, 24), False: (42, 24)}
# the SSOD path's shapes that no earlier row covers: (case, N, Lq)
SSOD_FWD_CASES = (("encoder_n4", 4, S), ("decoder_ssod", 4, 160 + 200 + 900))
# the eval batch's decoder (4 images, 900 queries), forward only
EVAL_FWD_CASES = (("decoder_eval", 4, 900),)
# the main path runs bfloat16: 16-byte chunks of 8 channels per lane
MAIN_WIDTH = 8
# kernel vs plain: float32 sums in another order (1e-5); bfloat16 output
# is one rounding of that sum, and the two may round a value that sits on a
# tie apart: one bf16 ulp at |out| < 4 is 2**-6
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# the float32 request, kernel against plain version through 6 encoder and
# 6 decoder layers (TF32 off)
TOL_MEMORY, TOL_LOGITS, TOL_COORDS = 1e-3, 1e-3, 1e-4
REQUESTS = ((480, 640), (640, 427), (427, 641), (599, 401))
# backward, kernel vs plain: each output's max abs error within GRAD_RTOL
# times its largest magnitude (float32 sums in another order; d_value's
# scatter in atomic order, which is not fixed); a bfloat16 d_value adds
# one bf16 rounding (2**-8 relative). The bfloat16 kernel is held against
# the plain backward of value.float() and grad.float(): it reads the same
# bf16 numbers and sums in float32.
GRAD_RTOL, BF16_ROUNDING = 1e-5, 2 ** -8
TRAIN_BATCH, TRAIN_LQ = 2, 900 + 200
# the training steps: (warm_up, bucket, GT counts of the two images)
TRAIN_STEPS = ((True, (800, 1344), (0, 7)), (True, (1344, 800), (100, 3)),
               (False, (800, 1344), (12, 0)), (False, (1344, 800), (100, 0)),
               (False, (800, 1344), (25, 60)))
# 5b, float32 gradients through kernels vs plain versions: relative L2 per
# leaf (float32 sums in other orders through 6 layers and the backbone);
# leaves whose gradient is below 1e-5 of the global norm on both sides are
# a true zero (a conv bias before GroupNorm, the key bias) and skipped.
# Where the two forwards differ, the model carries their rounding far: one
# float32 rounding of the plain MSDA output moves the encoder's leaves by
# up to ~1e-3 (phase 5b's witness), so TOL_GRAD_LEAF holds those
# comparisons. With one forward shared, only the backward kernel's sum
# order differs: TOL_BWD_ONLY is 5x the kernel-vs-kernel floor (~2e-6).
# The decoder, on one shared encoder output, reads ~2e-5; its limit is set
# in the call from its own sub-rounding witness (the plain version moved by
# one float32 rounding, which read up to ~7e-4), DECODER_WITNESS_FACTOR
# times that witness's worst leaf, as phases 8a and 10 set theirs.
TOL_GRAD_LEAF, TOL_BWD_ONLY, DECODER_WITNESS_FACTOR = 1e-3, 1e-5, 2.0
NEGLIGIBLE = 1e-5
# phase 7: the synthetic COCO set (labelled, unlabelled, val images of
# 480x640, up to 3 boxes and 2 distractors each, class "person") and the
# SSOD CLI's overrides of the recipe; everything else is the recipe's
TRAINER_SET = dict(hw=(480, 640), max_boxes=3, distractors=2,
                   class_name="person")
TRAINER_SPLITS = {"sup": range(0, 8), "unsup": range(8, 24),
                  "val": range(24, 32)}
# phase 7's data.classes: the 80 COCO names with TRAINER_RENAMED of them,
# index 0 (the synthetic set's class, which its annotation files carry)
# among them, replaced in turn by the names of the render case "names"
# (those without a control character; a repeat numbered), so the trainer's
# pseudo renders draw from
# Rubik past ASCII, the fallback font and the box
TRAINER_RENAMED, TRAINER_CLASSES_SEED = 16, 16
# the SSOD CLI's score_thr: with random weights the recipe's 0.4 keeps no
# pseudo label, so its renders would draw no label; at 0 each render draws
# the first image's pseudo labels (the launch counts do not depend on the
# kept sets, as phase 6's step at score_thr 0 shows)
TRAINER_SCORE_THR = 0.0
# the 480x640 lossless AVIF fixture and the lossy one (cv2.imwrite's
# defaults) phase 7a times and the trainer reads
AVIF_FIXTURE = "avif_480x640.avif"
AVIF_LOSSY_FIXTURE = "avif_lossy_480x640.avif"
# the AVIF fixtures of other writers' chroma layouts and colour
# descriptions and of several tiles; cv2's several-tile files (2x1 tiles,
# wider than 4096), whose decodes phase 7a times, the second of which the
# demo reads; the several-tile picture phase 7a's writer codes (2x1 tiles)
AVIF_OTHER_PREFIXES = ("avif_tiles_", "avif_layout_", "avif_colr_")
AVIF_TILE_FIXTURES = ("avif_tiles_300x4200.avif", "avif_tiles_256x4104.avif")
AVIF_TILE_WRITE = (256, 4104)
# one fixture of each format the JAX loader hands to cv2, among phase 7's
# unlabelled and val images beside the JPEG and PNG ones
TRAINER_CV2_FIXTURES = ("bmp_rle8.bmp", "pnm_p6_100.ppm",
                        "tiff_jpeg_ycbcr_tables.tif",
                        "webp_lossy_orient6.webp", "jpeg_lossless_p8.jpg",
                        "gif_offset_local_transparent.gif", "hdr_rle.hdr",
                        "j2k_lossy_layers.jp2", "j2k_raw.j2k", AVIF_FIXTURE,
                        AVIF_LOSSY_FIXTURE)
# the trainer's steps; warm-up steps 1-3 and Hungarian steps 5-7 are warm
# (median of each, against phase 6's); eval and render every
# TRAINER_INTERVAL steps and one checkpoint at the end, so none of them
# (nor a checkpoint's write-back) falls on a warm step
TRAINER_STEPS, TRAINER_WARM_UP, TRAINER_INTERVAL = 8, 4, 4
# the 480x640 high-throughput JPEG 2000 fixture phase 7a times and the
# demo reads
HT_DEMO_FIXTURE = "j2kh_480x640.jp2"
# phase 7r: the render. save_result against cv2's renders (native/fixtures/
# render.json and its PNGs), held by `tools.render_check` (boxes at max abs
# 0, each label at worst to an ink IoU of 0.95 and a mean abs of 2 levels;
# on the CPU it is bit-equal); the demo's inputs, one per format
RENDER_DEMO_INPUTS = ("colour_420.jpg", "bmp_24.bmp", "pnm_p6_100.ppm",
                      "tiff_lzw_predictor.tif", "webp_lossy.webp",
                      "pnm_p2_100.pgm", "other_pfm.pfm", "ras_pal8.ras",
                      "pam_rgb16.pam", "hdr_rle.hdr", "other_gif.gif",
                      "j2k_480x640_lossless.jp2", "tiffx_cielab_480x640.tif",
                      HT_DEMO_FIXTURE, "avif_480x640.avif",
                      "avif_lossy_480x640.avif", AVIF_TILE_FIXTURES[1])
RENDER_SIGNATURES = {"jpg": b"\xff\xd8", "bmp": b"BM", "ppm": b"P6",
                     "tif": b"II*\0", "webp": b"RIFF", "pfm": b"PF",
                     "ras": b"\x59\xa6\x6a\x95", "pam": b"P7",
                     "hdr": b"#?RADIANCE", "gif": b"GIF89a",
                     "jp2": b"\0\0\0\x0cjP  \r\n\x87\n",
                     "avif": b"\0\0\0\x20ftypavif"}
# the library's encoders whose files are cv2's bytes, or (AVIF) of cv2's
# headers and quantizer with the library's own tile, lossy: the demo's
# file must be the encoder's bytes for its render (and read back to a
# picture of the render's size: HDR within HDR_READBACK levels, GIF on the
# 3-3-2 table's steps, JPEG 2000 and AVIF through the library's decoder,
# an AVIF's RGB PSNR against its render printed; the CPU tests hold the
# AVIF encoder to within 0.5 dB of cv2's own round trip, and phase 7a's
# avif_writes this machine's encoder to the sandbox's bytes)
RENDER_LOSSY = {"jpg": native.encode_jpeg, "hdr": native.encode_hdr,
                "gif": native.encode_gif, "jp2": native.encode_jp2,
                "avif": native.encode_avif}
HDR_READBACK = 2
TRAINER_WARM = {"warm_up": (1, 2, 3), "hungarian": (5, 6, 7)}
# then the trainer's steps on its next batches, built beforehand (no
# prefetch thread beside them): QUIET_STEPS of each stage
QUIET_STEPS = 3
EVAL_BATCH = 4
OD_STEPS, OD_BATCH = 2, 2
# phase 8a: two ranks (gloo on the one card; NCCL, one per card, where
# there are two). The float32 equality run (TF32 off in the ranks and in
# the parent): DDP_EQ_IMAGES (sup, unsup) per rank, a warm-up step at
# phase 6's lowered score_thr (a non-empty supervision set) and a
# Hungarian step, against one process on the global batch, each step from
# the state the ranks started it from. The ranks' kept sets and GMM element
# must equal one process's, and the Hungarian columns too or be a near tie
# held by its matching cost (`tools.hungarian_hold`: a discrete choice the
# witnesses flip cannot be held to equality). Its continuous limits
# come from witnesses: the same one-process step with every image value
# moved by one float32 rounding, up and down. One process is not stable
# under them at full width with random weights (the two-stage top-k over
# 22,323 tokens, NMS, the solves and the GMM pick flip; NVIDIA H100 80GB
# HBM3, 700.00 W: one rounding moved total_loss by 0.17 % and picked
# another GMM element), so a loss term, the total, grad_norm, gmm_thr or
# the per-leaf update errors (worst and median) may move by WITNESS_FACTOR
# times the witnesses' largest distance from one process, plus DDP_FLOOR
# of the total loss (a term) or of the value itself. The timing run: the
# recipe's 1 + 4 per rank in bfloat16: a warm-up step that carries the
# first-call costs, a warm one, and a Hungarian step (warm after them: the
# layout legs, timed so, read it 4,301-6,095 ms against 4,057-5,733 for
# the warm warm-up step; NVIDIA H100 80GB HBM3, 700.00 W); one step of each
# stage past the first call, to keep the smoke under 900 s.
# Every rank is joined within DDP_TIMEOUT seconds or killed.
DDP_WORLD, DDP_EQ_IMAGES = 2, (1, 2)
DDP_EQ_STEPS = ((True, 0.0), (False, None))
DDP_TIME_STEPS = ((True, None),) * 2 + ((False, None),)
WITNESS_FACTOR, DDP_FLOOR, DDP_TIMEOUT = 4.0, 1e-6, 420
WITNESS_NUDGES = (1, -1)
# phase 8c: the layouts, (name, fsdp, tp, world): gloo ranks on the one
# card (NCCL, one per card, where there are as many); each leg's float32
# equality run and bfloat16 timing run are phase 8a's. An FSDP leg's local
# state (parameters, gradients, moments, teacher) is at most
# LAYOUT_STATE_SHARE of the data-parallel rank's (half, and the leaves too
# small to shard); a TP rank holds 1 / tp of the FFN pairs but their 12
# linear2 biases (TP_REPLICATED_FFN parameters). The SSOD CLI with
# fsdp=True tp=2 donate=True over LAYOUT_CLI_WORLD ranks: LAYOUT_CLI_STEPS
# steps on phase 7's set (a warm-up step, a Hungarian step), an eval and a
# checkpoint at the end.
LAYOUT_LEGS = (("fsdp", True, 1, 2), ("tp", False, 2, 2),
               ("fsdp_tp", True, 2, 4))
# the float32 equality run of a leg: phase 8a's two steps under FSDP; a TP
# leg's stops after the first, the warm-up step, which holds the TP ranks'
# gradients before the model group's broadcast and every discrete choice
# against one process in the TP order (the Hungarian step after it held
# the same on the card, NVIDIA H100 80GB HBM3, 700.00 W)
def layout_eq_steps(tp):
    return DDP_EQ_STEPS if tp == 1 else DDP_EQ_STEPS[:1]


# each leg's bfloat16 timing run: a Hungarian step that carries the
# first-call costs and a warm one (the warm-up stage is timed by phase 8a
# and phase 6, not again here, to keep the smoke under 900 s; a TP leg's
# equality run takes only the warm-up step, so this run is its Hungarian
# step on the card)
LAYOUT_TIME_STEPS = ((False, None),) * 2
# under TP: each rank's gradients before the model group's broadcast
# against its first rank's, per leaf, held to ALIGN_FACTOR times the
# floor of one process taking the same step twice (the atomic order of
# the backward's sums), worst leaf and median
ALIGN_FACTOR = 4.0
# the update in chunks against the whole state in one call, in turns
DONATION_ROUNDS = 5
LAYOUT_STATE_SHARE, TP_REPLICATED_FFN = 0.55, 12 * 256
LAYOUT_CLI_WORLD, LAYOUT_CLI_STEPS, LAYOUT_TIMEOUT = 4, 2, 480
# phase 8b: the SSOD CLI under torch.distributed.run (NCCL, world 1) on
# phase 7's set: 2 warm-up and 2 Hungarian steps, eval after step 2, a
# checkpoint at the end; killed after TORCHRUN_TIMEOUT seconds
TORCHRUN_STEPS, TORCHRUN_WARM_UP, TORCHRUN_TIMEOUT = 4, 2, 300
# the argument that makes this script phase 8b's rank under the launcher
TORCHRUN_FLAG = "--torchrun-ssod-cli"
# phase 7a: the committed JPEG fixtures against their libjpeg pixels.
# Every stream libjpeg decodes (Huffman or arithmetic, sequential or
# progressive, smoothed or not, gray, YCbCr, RGB; and CMYK / YCCK as cv2
# turns them) decodes in the host library on either route, exactly:
# tolerance (0, 0). The back end's own decode of the three original
# fixtures is held as a witness: nvJPEG's IDCT is not libjpeg's (it read
# max abs 2, mean abs 0.039 grey levels on the colour fixture and 1 / 0.021
# on the gray one; NVIDIA H100 80GB HBM3, 700.00 W; libnvjpeg.so.12.4.0.76);
# the limit on (max abs, mean abs) leaves a level for another IDCT build.
# No stream of a kind the host decoders take reaches it in decode_image.
NVJPEG_TOL = (3, 0.1)
# the card's JPEG encode + decode against cv2's quality-95 round trip of
# the same picture (native/fixtures/cv2_q95_roundtrip.json): grey levels
# added to cv2's (max abs, mean abs). Another DCT moves the mean by a small
# part of a level; nvJPEG's own RGB input, which truncates its luma, added
# more than half a level on the colour fixture's picture, and fails here
ROUND_TRIP_SLACK = (8, 0.25)
HOST_SRC, HOST_VIEW = (480, 640), (800, 1066)
# phases 9 and 9b: the serving programs exported by tools.export_model at
# batch 1, (name, NMS decode, bucket): the top-k and NMS programs of the
# landscape bucket, and the top-k program of the portrait one (a request
# fills the bucket of its orientation), with phase 4's seeded weights.
# Phase 9 loads and runs the landscape ones in a fresh process (this script
# with EXPORT_FLAG) on phase 4's packed requests of their bucket, timed
# over EXPORT_REPS warm runs each.
SERVED = (("topk", False, (800, 1344)), ("nms", True, (800, 1344)),
          ("topk_portrait", False, (1344, 800)))
EXPORT_BUCKET, EXPORT_REPS = (800, 1344), 5
EXPORT_FLAG, PACKAGE_FLAG = "--run-exported", "--package-program"
# Phase 9b packages each program of SERVED with AOTInductor (bfloat16,
# full width), and FLOAT32_PACKAGE, each in a compiling process of its
# own (this script with PACKAGE_FLAG), all started together as phase 9
# saves them, before phase 8a: the compiles run beside phases 8a-11, and
# 9b, at the end, waits for them. Each compiling process takes
# PACKAGE_THREADS Inductor compile threads (TORCHINDUCTOR_COMPILE_THREADS;
# Inductor's default is one per core, 8 on the card's machine), niced by
# PACKAGE_NICE so that they take the cores the phases beside them leave
# idle. The top-k compiled first and alone, then the other three together
# from its warm Inductor cache, took 202.9 s and then 184.0-202.9 s each,
# 500.1 s of wall time, where four at once had taken 239-277 s each,
# 355.7 s (two runs of this script, on slow hosts; NVIDIA H100
# 80GB HBM3, 700.00 W): the lead's cache saved the others little. The
# loading
# process runs every package, the C++ runner (tools.serve_runner) the
# bfloat16 ones, on the requests of its bucket; every process is killed
# after PACKAGE_TIMEOUT seconds. Inductor fuses the bfloat16 elementwise
# work and rounds elsewhere than eager `predict`, and with random weights
# the scores crowd together, so near ties trade places: a development call
# read boxes by rank ~1,000 px apart and 137-185 of 300 labels by rank
# differing in the witnesses alone (eager on the request moved by one
# bfloat16 rounding, WITNESS_NUDGES units in the last place; NVIDIA H100
# 80GB HBM3, 700.00 W). A bfloat16 package is therefore held to eager by
# its scores in descending order, within PACKAGE_WITNESS_FACTOR times the
# witnesses' largest distance, and the runner's outputs to the
# Python-loaded package's to the bit. In float32 (TF32 off) the package
# matches eager's encoder memory within 1.3e-5, but the two-stage
# selection's near ties still decide: eager on its input moved by one
# float32 rounding chose other proposals in 3 of 4 tries, and 288-297 of
# its 300 detections left FLOAT32_TOL by rank (a development call, same
# card). So the float32 program holds its selection fixed:
# `SelectionGiven`, the top-k program with eager's selection as an input,
# packaged as FLOAT32_PACKAGE, is held to float32 eager, its encoder memory
# by position and its answer by rank (`held_by_rank`), within FLOAT32_TOL,
# the CPU package test's tolerance (tests/test_torch_package.py).
FLOAT32_PACKAGE = "topk_f32_given"
PACKAGE_THREADS, PACKAGE_NICE = 2, 10
FLOAT32_TOL = dict(rtol=1e-4, atol=1e-4)
PACKAGE_TIMEOUT, PACKAGE_WITNESS_FACTOR = 900, 2.0
# phase 10: remat against no remat from one state, per path and stage,
# REMAT_ROUNDS times in turns (no remat, remat, ...), held by
# `tools.remat_check.check_remat` (its docstring: the loss terms
# bit-equal; every gradient leaf and every update leaf up to NOISE_LEAF
# within REMAT_FACTOR times its own floor plus one bfloat16 rounding, the
# medians within REMAT_FACTOR times the floor's; the ~190 noise leaves'
# ratio of error to floor held at its 0.9 quantile within twice the same
# statistic between runs of one mode in this call, its median within
# REMAT_FACTOR, its maximum printed beside the witness's). The warm step
# times are the medians of the runs of each mode after its first.
REMAT_ROUNDS = 4
# phase 11: tools.recipe_rehearsal at full width on a small set: 8 steps,
# the warm-up boundary at 4, the kill (end of leg 1) at 5, eval every 3
# steps (once in each leg), every step logged
REHEARSAL_STEPS, REHEARSAL_IMGS, REHEARSAL_EVAL = 8, 40, 3


def log(msg):
    print(msg, flush=True)


def json_safe(x):
    """NaN (an AP over an area range without GT) as null: the record line
    stays strict JSON."""
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def widths_of(wrapper, fn):
    """fn()'s result and the kernel instances (widths) its launches took."""
    before = dict(wrapper.launches_by_width)
    out = fn()
    after = dict(wrapper.launches_by_width)
    return out, {w: c - before.get(w, 0) for w, c in after.items()
                 if c != before.get(w, 0)}


def reset_counts():
    for wrapper in (msda.ms_deform_attn_cuda, msda.ms_deform_attn_bwd_cuda):
        wrapper.launches = 0
        wrapper.launches_by_width.clear()


def assert_vector(wrapper, what):
    """Every launch counted since the last reset took the vector instance
    of the main path's dtype."""
    by_width = dict(wrapper.launches_by_width)
    if by_width != {MAIN_WIDTH: wrapper.launches}:
        raise AssertionError(f"{what}: {wrapper.launches} launches by width "
                             f"{by_width}, not all {MAIN_WIDTH}")


def grid_sample_msda(value, loc, attn):
    """The grid_sample composite of the reference's
    ms_deform_attn_core_pytorch, timed only as a yardstick."""
    F = torch.nn.functional
    n, _, m, d = value.shape
    lq = loc.shape[1]
    vals = value.split([h * w for h, w in SHAPES], 1)
    outs = []
    for lid, (h, w) in enumerate(SHAPES):
        v = vals[lid].permute(0, 2, 3, 1).reshape(n * m, d, h, w)
        gr = (2 * loc[:, :, :, lid] - 1).permute(0, 2, 1, 3, 4).reshape(
            n * m, lq, P, 2).to(v.dtype)
        outs.append(F.grid_sample(v, gr, mode="bilinear",
                                  padding_mode="zeros", align_corners=False))
    a = attn.permute(0, 2, 1, 3, 4).reshape(n * m, 1, lq, -1).to(value.dtype)
    out = (torch.stack(outs, -2).flatten(-2) * a).sum(-1)
    return out.reshape(n, m * d, lq).transpose(1, 2)


def kernel_phase():
    log("== phase 3: MSDA kernel against its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    cases = [(name, 1, lq, oob, dtypes) for name, lq, oob in (
        ("encoder", S, False), ("decoder", 900, False),
        ("out_of_bounds", 900, True))
        for dtypes in [(torch.float32, torch.bfloat16)]]
    cases += [(name, n, lq, False, (torch.bfloat16,))
              for name, n, lq in SSOD_FWD_CASES + EVAL_FWD_CASES]
    for name, n, lq, oob, dtypes in cases:
        for dtype in dtypes:
            value, loc, attn = msda_inputs(lq, dtype, seed=len(rows),
                                           oob=oob, n=n)
            got, widths = widths_of(msda.ms_deform_attn_cuda,
                                    lambda: msda.ms_deform_attn_cuda(
                                        value, SHAPES, loc, attn))
            ref = ms_deform_attn(value, SHAPES, loc, attn)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            # the share of outputs equal to the plain version's to the bit
            # (the kernel sums in the order of torch's reduction there)
            same = (got == ref).float().mean().item()
            if not (err <= TOL[dtype]) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {dtype}: max abs err {err} > "
                                     f"{TOL[dtype]}")
            if dtype == torch.float32 and not oob and same != 1.0:
                raise AssertionError(
                    f"{name} float32: {same:.6f} of the outputs equal the "
                    "plain version's to the bit, not all: torch's reduction "
                    "order is not the forward kernel's")
            k_ms = cuda_ms(lambda: msda.ms_deform_attn_cuda(
                value, SHAPES, loc, attn), 50)
            p_ms = cuda_ms(lambda: ms_deform_attn(value, SHAPES, loc, attn), 5)
            y_ms = (cuda_ms(lambda: grid_sample_msda(value, loc, attn), 5)
                    if dtype == torch.float32 else None)
            b_ms, b_by = bound(lq, dtype, n)
            rate = gathered_bytes(n, lq, dtype) / (k_ms * 1e-3)
            rows.append(dict(case=name, dtype=str(dtype).split(".")[-1],
                             n=n, lq=lq, width=widths, max_abs_err=err,
                             bit_equal_share=same,
                             tol=TOL[dtype], ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             gathered_bytes_per_s=rate, grid_sample_ms=y_ms))
            log(f"  {name:13s} {rows[-1]['dtype']:8s} N={n} Lq={lq:6d} "
                f"err={err:.3e} (tol {TOL[dtype]:.1e}, bit-equal share "
                f"{same:.4f})  width {widths}  "
                f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound "
                f"{b_ms:.4f} ms ({b_by})  gathered rows {rate / 1e12:.3f} "
                f"TB/s  grid_sample yardstick {y_ms} ms")
            del value, loc, attn, got, ref
            torch.cuda.empty_cache()
    return rows


def check_answer(img, answer):
    boxes, scores, labels = answer
    h, w = img.shape[:2]
    if len(scores) != 300 or not np.isfinite(scores).all():
        raise AssertionError(f"{len(scores)} detections, finite "
                             f"{np.isfinite(scores).all()}")
    eps = 1e-2
    inside = ((boxes[:, 0] >= -eps) & (boxes[:, 1] >= -eps)
              & (boxes[:, 2] <= w + eps) & (boxes[:, 3] <= h + eps)
              & (boxes[:, 2] >= boxes[:, 0]) & (boxes[:, 3] >= boxes[:, 1]))
    if not inside.all() or boxes.shape != (300, 4) or labels.shape != (300,):
        raise AssertionError(f"boxes outside image {(h, w)}")


def main_path_phase():
    log("== phase 4: main path (full width, bfloat16, seeded weights)")
    t0 = time.perf_counter()
    topk = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=0)
    refine_boxes(topk.detector, seed=0)
    nms = Predictor(topk.detector, topk.class_names, use_nms=True)
    log(f"  init_detector: {time.perf_counter() - t0:.1f} s, compute dtype "
        f"{topk.detector.compute_dtype}")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in REQUESTS]

    reset_counts()
    forwards = 0
    for pred in (topk, nms):                  # warm-up, checked too
        for img in images:
            check_answer(img, pred(img, score_thr=-1.0))
            forwards += 1
    timed = {}
    for label, pred in (("topk", topk), ("nms", nms)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            for img in images:
                check_answer(img, pred(img, score_thr=-1.0))
                forwards += 1
        dt = (time.perf_counter() - t0) / (3 * len(images))
        timed[label] = dt
        log(f"  {label}: warm latency {dt * 1e3:.2f} ms/request, "
            f"{1.0 / dt:.3f} images/s over {3 * len(images)} requests")
    launches = msda.ms_deform_attn_cuda.launches
    log(f"  MSDA kernel launches: {launches} over {forwards} forwards")
    if launches == 0 or launches != 12 * forwards:
        raise AssertionError(f"expected {12 * forwards} launches, got "
                             f"{launches}")
    assert_vector(msda.ms_deform_attn_cuda, "serving path")
    del topk, nms
    torch.cuda.empty_cache()
    return launches, timed


def float32_phase():
    log("== phase 4b: one float32 request, kernel against plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pred = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=0,
                         cfg_options={"model.dtype": "float32"})
    det = refine_boxes(pred.detector, seed=1)
    img = np.random.RandomState(1).randint(0, 256, (599, 401, 3)).astype(
        np.uint8)
    images, hw, _ = pred.preprocess(img)

    kernel_dispatch = tr.ms_deform_attn_auto
    with torch.inference_mode():
        enc_k = det.encode_images(images, hw)
        out_k = det.decode_queries(enc_k)
        tr.ms_deform_attn_auto = ms_deform_attn       # the plain version
        try:
            enc_p = det.encode_images(images, hw)
            out_p = det.decode_queries(enc_k)         # same selection
            # the plain version with its output scaled by 1 + 2**-10
            tr.ms_deform_attn_auto = lambda *a: ms_deform_attn(*a) * (
                1 + 2 ** -10)
            out_moved = det.decode_queries(enc_k)
        finally:
            tr.ms_deform_attn_auto = kernel_dispatch
    errs = {
        "memory": (enc_k["memory"] - enc_p["memory"]).abs().max().item(),
        "logits": (out_k["cls"] - out_p["cls"]).abs().max().item(),
        "coords": (out_k["coord"] - out_p["coord"]).abs().max().item(),
    }
    same_topk = bool(torch.equal(enc_k["refpoint_unsig"],
                                 enc_p["refpoint_unsig"]))
    log(f"  max abs err: encoder memory {errs['memory']:.3e} (tol "
        f"{TOL_MEMORY}), decoder logits {errs['logits']:.3e} (tol "
        f"{TOL_LOGITS}), coords {errs['coords']:.3e} (tol {TOL_COORDS}); "
        f"two-stage selection identical: {same_topk}")
    for key, tol in (("memory", TOL_MEMORY), ("logits", TOL_LOGITS),
                     ("coords", TOL_COORDS)):
        if not errs[key] <= tol:
            raise AssertionError(f"float32 {key}: {errs[key]} > {tol}")
    # with the box layers filled, the coordinates depend on what the
    # decoder's MSDA returns: moving its output must move them (the kernel
    # itself may agree with the plain version to the bit)
    if torch.equal(out_moved["coord"], out_p["coord"]):
        raise AssertionError("float32 coords do not depend on the MSDA")
    for t in (out_k["cls"], out_k["coord"]):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite float32 output")
    return errs


def grid_sample_bwd_ms(value, loc, attn, g, reps):
    """Device ms of the backward of the grid_sample composite (value, loc
    and attn), timed alone: a yardstick, not an MSDA of the library."""
    ins = [t.detach().requires_grad_(True) for t in (value, loc, attn)]
    out = grid_sample_msda(*ins)
    return cuda_ms(lambda: torch.autograd.grad(
        out, ins, g.to(out.dtype), retain_graph=True), reps)


def grad_errors(got, ref, dtype):
    """[(max abs err, tol)] of d_value, d_loc, d_attn where the plain result
    is finite; the kernel must give exactly 0 where it is not."""
    rows = []
    for i, (a, b) in enumerate(zip(got, ref)):
        fin = torch.isfinite(b)
        if not torch.equal(a.float()[~fin], torch.zeros_like(a.float()[~fin])):
            raise AssertionError("kernel gradient not 0 at a NaN location")
        scale = max(1.0, b[fin].abs().max().item())
        tol = GRAD_RTOL * scale + (BF16_ROUNDING * scale
                                   if i == 0 and dtype == torch.bfloat16
                                   else 0.0)
        err = (a.float() - b.float())[fin].abs().max().item()
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite kernel gradient")
        rows.append((err, tol))
    return rows


def backward_kernel_phase():
    log("== phase 3b: MSDA backward kernel against its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    both = (torch.float32, torch.bfloat16)
    cases = [(name, TRAIN_BATCH, lq, oob, both) for name, lq, oob in (
        ("encoder", S, False), ("decoder", TRAIN_LQ, False),
        ("out_of_bounds", TRAIN_LQ, True))]
    cases += [(name, n, lq, False, (torch.bfloat16,))
              for name, n, lq in SSOD_FWD_CASES]
    for name, n, lq, oob, dtypes in cases:
        for dtype in dtypes:
            seed = 100 + len(rows)
            value, loc, attn = msda_inputs(lq, dtype, seed, oob=oob, n=n)
            g = torch.randn(n, lq, M * D, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                seed)).to(dtype)
            got, widths = widths_of(msda.ms_deform_attn_bwd_cuda,
                                    lambda: msda.ms_deform_attn_bwd_cuda(
                                        value, SHAPES, loc, attn, g))
            ref = ms_deform_attn_backward_autograd(value.float(), SHAPES,
                                                   loc, attn, g.float())
            torch.cuda.synchronize()
            errs = grad_errors(got, ref, dtype)
            del got, ref
            for (err, tol), out in zip(errs, ("d_value", "d_loc", "d_attn")):
                if not err <= tol:
                    raise AssertionError(f"{name} {dtype} {out}: max abs err "
                                         f"{err} > {tol}")
            k_ms = cuda_ms(lambda: msda.ms_deform_attn_bwd_cuda(
                value, SHAPES, loc, attn, g), 20)
            p_ms = cuda_ms(lambda: ms_deform_attn_backward_autograd(
                value, SHAPES, loc, attn, g), 3)
            y_ms = (grid_sample_bwd_ms(value, loc, attn, g, 3)
                    if dtype == torch.float32 and not oob else None)
            b_ms, b_by = bound_bwd(n, lq, dtype)
            rate = gathered_bytes(n, lq, dtype) / (k_ms * 1e-3)
            rows.append(dict(case=name, dtype=str(dtype).split(".")[-1],
                             n=n, lq=lq, width=widths,
                             max_abs_err={o: e for o, (e, _) in zip(
                                 ("d_value", "d_loc", "d_attn"), errs)},
                             tol={o: t for o, (_, t) in zip(
                                 ("d_value", "d_loc", "d_attn"), errs)},
                             ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, gathered_bytes_per_s=rate,
                             grid_sample_bwd_ms=y_ms))
            log(f"  {name:13s} {rows[-1]['dtype']:8s} N={n} Lq={lq:6d} err "
                + " ".join(f"{o}={e:.3e}(tol {t:.1e})" for o, (e, t) in zip(
                    ("d_value", "d_loc", "d_attn"), errs))
                + f"  width {widths}  kernel {k_ms:.4f} ms  plain "
                f"{p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  gathered rows "
                f"{rate / 1e12:.3f} TB/s  grid_sample bwd yardstick {y_ms} ms")
            del value, loc, attn, g
            torch.cuda.empty_cache()
    return rows


def train_phase(card):
    log("== phase 5: training path (full width, bfloat16 compute, float32 "
        "parameters, seeded weights, batch 2)")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(CONFIG, device="cuda", seed=0)
    model = state.model
    log(f"  compute dtype {model.compute_dtype}, parameter dtypes "
        f"{sorted({str(p.dtype) for p in model.parameters()})}")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    steps = {wu: make_supervised_train_step(warm_up=wu, seed=0)
             for wu in (True, False)}
    rng = np.random.RandomState(5)
    batches = [to_device(synthetic_batch(rng, bucket, counts,
                                         model.cfg.max_gt), "cuda")
               for _, bucket, counts in TRAIN_STEPS]
    records = []
    fwd_total = bwd_total = 0
    for (warm_up, bucket, counts), batch in zip(TRAIN_STEPS, batches):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = steps[warm_up](state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fwd = msda.ms_deform_attn_cuda.launches
        bwd = msda.ms_deform_attn_bwd_cuda.launches
        fwd_total += fwd
        bwd_total += bwd
        vals = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"step {state.step}: non-finite {bad}")
        if (fwd, bwd) != (12, 12):
            raise AssertionError(f"step {state.step}: {fwd} forward and "
                                 f"{bwd} backward MSDA launches, not 12 + 12")
        assert_vector(msda.ms_deform_attn_cuda, f"step {state.step} forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda,
                      f"step {state.step} backward")
        records.append(dict(step=state.step - 1, warm_up=warm_up,
                            bucket=list(bucket), gt_counts=list(counts),
                            ms=dt * 1e3, total_loss=vals["total_loss"],
                            grad_norm=vals["grad_norm"],
                            launches_fwd=fwd, launches_bwd=bwd))
        log(f"  step {state.step - 1} {'O2M+TAL' if warm_up else 'Hungarian'}"
            f" bucket {bucket} GT {counts}: {dt * 1e3:.1f} ms, total_loss "
            f"{vals['total_loss']:.4f}, grad_norm {vals['grad_norm']:.4f}, "
            f"MSDA launches {fwd} fwd + {bwd} bwd")
    peak = torch.cuda.max_memory_allocated()
    frozen_moved = [k for k, p in model.named_parameters()
                    if not p.requires_grad and not torch.equal(p, before[k])]
    still = [k for k, p in model.named_parameters()
             if p.requires_grad and torch.equal(p, before[k])]
    n_frozen = sum(not p.requires_grad for p in model.parameters())
    if frozen_moved or still or n_frozen == 0:
        raise AssertionError(f"frozen moved: {frozen_moved[:5]}; trainable "
                             f"unmoved: {still[:5]}; frozen {n_frozen}")
    warm = [r["ms"] for r in records[1:]]
    warm_ms = float(np.median(warm))
    log(f"  {len(records)} steps; every trainable parameter moved, the "
        f"{n_frozen} frozen stem/layer1 tensors did not; warm step (median "
        f"of steps 1-4) {warm_ms:.1f} ms, "
        f"{TRAIN_BATCH / warm_ms * 1e3:.3f} images/s; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    log("  " + card)
    del state, model, batches
    torch.cuda.empty_cache()
    return dict(steps=records, warm_step_ms=warm_ms,
                images_per_s=TRAIN_BATCH / warm_ms * 1e3,
                peak_memory_bytes=peak, launches_fwd=fwd_total,
                launches_bwd=bwd_total, card=card)


def ssod_phase(card):
    log("== phase 6: SSOD path (full width, 1 + 4 images at 800x1344, "
        "bfloat16 compute, float32 parameters, seeded weights)")
    torch.cuda.reset_peak_memory_stats()
    state, cfg = init_ssod_state(SSOD_CONFIG, device="cuda", seed=0)
    model, projector, teacher = state.model, state.projector, state.teacher
    refine_boxes(model, seed=3)
    log(f"  compute dtype {model.compute_dtype}; max_pseudo {cfg.max_pseudo},"
        f" cons_groups {cfg.cons_groups}, score_thr {cfg.score_thr}")
    batch = to_device(synthetic_ssod_batch(
        SSOD_SUP, SSOD_UNSUP, *SSOD_BUCKET, model.cfg.max_gt,
        gt_per_image=12, seed=0, student_flip=True), "cuda")
    frozen = {k: p.detach().clone() for k, p in model.named_parameters()
              if not p.requires_grad}
    if not frozen:
        raise AssertionError("no frozen parameters")
    records = []
    fwd_total = bwd_total = 0
    for i, (warm_up, thr) in enumerate(SSOD_STEPS):
        step_cfg = cfg if thr is None else dataclasses.replace(
            cfg, score_thr=thr)
        step = make_ssod_train_step(step_cfg, warm_up)
        proj_before = [p.detach().clone() for p in projector.parameters()]
        teacher_before = [p.detach().clone() for p in teacher.parameters()]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fwd = msda.ms_deform_attn_cuda.launches
        bwd = msda.ms_deform_attn_bwd_cuda.launches
        fwd_total += fwd
        bwd_total += bwd
        vals = {k: float(v) for k, v in metrics.items()
                if k not in ("pseudo_vis", "pseudo_sets")}
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"SSOD step {i}: non-finite {bad}")
        if (fwd, bwd) != SSOD_LAUNCHES[warm_up]:
            raise AssertionError(f"SSOD step {i}: {fwd} forward and {bwd} "
                                 f"backward MSDA launches, not "
                                 f"{SSOD_LAUNCHES[warm_up]}")
        assert_vector(msda.ms_deform_attn_cuda, f"SSOD step {i} forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda, f"SSOD step {i} backward")
        # the projector moves every step: after the warm-up on a zero
        # gradient, by Adam's momentum and the weight decay
        if any(torch.equal(p, q) for p, q in zip(projector.parameters(),
                                                 proj_before)):
            raise AssertionError(f"SSOD step {i}: a projector tensor did not "
                                 "move")
        moved = [k for k, p in model.named_parameters()
                 if k in frozen and not torch.equal(p, frozen[k])]
        if moved:
            raise AssertionError(f"SSOD step {i}: frozen moved: {moved[:5]}")
        # step 0's momentum is 0: the teacher becomes the student it was
        # copied from; from step 1 the EMA moves it
        t_moved = sum(not torch.equal(p, q) for p, q in
                      zip(teacher.parameters(), teacher_before))
        if i and t_moved == 0:
            raise AssertionError(f"SSOD step {i}: the teacher did not move")
        if thr is not None and not vals["sup_set_per_img"] > 0:
            raise AssertionError(f"SSOD step {i}: empty supervision set at "
                                 f"score_thr {thr}")
        rec = dict(step=i, warm_up=warm_up, score_thr=step_cfg.score_thr,
                   ms=dt * 1e3, launches_fwd=fwd, launches_bwd=bwd,
                   teacher_tensors_moved=t_moved,
                   **{k: vals[k] for k in (
                       "total_loss", "grad_norm", "ema_momentum",
                       "pseudo_per_img", "sup_set_per_img",
                       "cons_set_per_img", "gmm_thr")})
        records.append(rec)
        log(f"  step {i} {'warm-up' if warm_up else 'Hungarian'} score_thr "
            f"{step_cfg.score_thr}: {dt * 1e3:.1f} ms, total_loss "
            f"{rec['total_loss']:.4f}, grad_norm {rec['grad_norm']:.4f}, "
            f"pseudo/img {rec['pseudo_per_img']:.2f}, sup set/img "
            f"{rec['sup_set_per_img']:.2f}, cons set/img "
            f"{rec['cons_set_per_img']:.2f}, gmm_thr {rec['gmm_thr']:.4f}, "
            f"MSDA launches {fwd} fwd + {bwd} bwd")
    peak = torch.cuda.max_memory_allocated()
    n_img = SSOD_SUP + SSOD_UNSUP
    warm = {stage: float(np.median([records[k]["ms"] for k in ks]))
            for stage, ks in SSOD_WARM.items()}
    log(f"  warm step ms (median of steps {SSOD_WARM['warm_up']} / "
        f"{SSOD_WARM['hungarian']}): warm-up {warm['warm_up']:.1f}, Hungarian "
        f"{warm['hungarian']:.1f}; images/s: warm-up "
        f"{n_img / warm['warm_up'] * 1e3:.3f}, Hungarian "
        f"{n_img / warm['hungarian'] * 1e3:.3f}; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    log("  " + card)
    del state, model, projector, teacher, batch
    torch.cuda.empty_cache()
    return dict(steps=records, warm_step_ms=warm,
                images_per_s={k: n_img / v * 1e3 for k, v in warm.items()},
                peak_memory_bytes=peak, launches_fwd=fwd_total,
                launches_bwd=bwd_total, card=card)


def read_evals(log_path):
    """{(tag, step): {metric: value}} from the trainer's Eval lines."""
    out = {}
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Eval\[(\w+)\] iter (\d+): (.*)$", line)
            if m:
                out[(m.group(1), int(m.group(2)))] = {
                    k: float(v) for k, v in (kv.split("=") for kv in
                                             m.group(3).split())}
    return out


def check_aps(res, what):
    """Every AP and AR in [0, 1]; NaN only for the small and medium area
    ranges, which hold no GT box of the synthetic set (all boxes are
    larger than 96 x 96 pixels)."""
    for k, v in res.items():
        if not isinstance(v, float):
            continue
        if math.isnan(v) and k in ("mAP_s", "mAP_m", "AR_s", "AR_m"):
            continue
        if not 0.0 <= v <= 1.0:
            raise AssertionError(f"{what}: {k} = {v}")


def best_ms(fn, reps=3):
    """The fastest of `reps` host-clock runs of fn(), in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def host_picture(h, w, seed):
    """Seeded noise over gradients at a photo's size."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (xs // 3 + ys // 2)[..., None] + 60 * np.arange(3)
    return ((base + rs.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


class OneOp:
    """A generator stand-in that hands apply_color_op (op, magnitude)."""

    def __init__(self, op, mag):
        self.values = [op, mag]

    def integers(self, *args):
        return self.values.pop(0)


def host_library_phase(host_build_s):
    log("== phase 7a: host library on the card (decode, resize, warp, "
        "colour ops, each against its numpy plain version)")
    found = native.probe()
    route = found["route"]
    log(f"  probe: {found}")
    log(f"  decoders {native.decoders()}; g++ build {host_build_s:.1f} s "
        "(phase 2)")
    fixtures = {}
    for name in ("colour_420", "gray", "progressive_420"):
        jpg = os.path.join(native.FIXTURES, f"{name}.jpg")
        with open(jpg, "rb") as f:
            buf = f.read()
        with open(os.path.join(native.FIXTURES, f"{name}.png"), "rb") as f:
            png = f.read()
        ref = image_io.decode_png(png)
        if not np.array_equal(native.decode_image(png), ref):
            raise AssertionError(f"{name}.png: the library's PNG decode "
                                 "differs from the numpy decoder's")
        kind = native.jpeg_host_kind(buf)
        if kind != ("progressive" if "progressive" in name
                    else "sequential"):
            raise AssertionError(f"{name}.jpg: the host decoders' kind "
                                 f"{kind}")
        got = native.decode_image(buf, jpg)
        diff = np.abs(got.astype(int) - ref.astype(int))
        # the back end's own decode (nvJPEG on the card), which these
        # streams no longer take, beside it
        back = native.decode_jpeg_backend(buf, jpg)
        bdiff = np.abs(back.astype(int) - ref.astype(int))
        fixtures[name] = dict(
            shape=list(got.shape), route=native.decoders()[f"jpeg_{kind}"],
            max_abs=int(diff.max()), mean_abs=float(diff.mean()),
            share_differing=float((diff > 0).mean()),
            ms=best_ms(lambda: native.decode_image(buf)),
            backend=native.decoders()["jpeg"],
            backend_max_abs=int(bdiff.max()),
            backend_mean_abs=float(bdiff.mean()),
            backend_ms=best_ms(lambda: native.decode_jpeg_backend(buf)))
        log(f"  fixture {name} ({fixtures[name]['route']}): max abs "
            f"{diff.max()}, mean abs {diff.mean():.4f}, "
            f"{fixtures[name]['ms']:.3f} ms; the back end's decode "
            f"({fixtures[name]['backend']}): max abs {bdiff.max()}, mean abs "
            f"{bdiff.mean():.4f}, {fixtures[name]['backend_ms']:.3f} ms")
        # sequential and progressive streams decode libjpeg-exact on
        # either route
        if got.shape != ref.shape or diff.max() > 0:
            raise AssertionError(f"fixture {name}: {fixtures[name]} not "
                                 "libjpeg's pixels")
        tol = (0, 0.0) if route == "libjpeg" else NVJPEG_TOL
        if bdiff.max() > tol[0] or bdiff.mean() > tol[1]:
            raise AssertionError(f"fixture {name}: the {route} back end "
                                 f"beyond (max, mean) {tol}")

    formats = format_fixtures()
    ops = {}

    def held(name, args, reps=3):
        """native.name(*args) against NumpyPixels.name(*args): bit-equal,
        and the ms of each."""
        got = getattr(native, name)(*args)
        ref = getattr(augment.NumpyPixels, name)(*args)
        if got.shape != ref.shape or not np.array_equal(got, ref):
            raise AssertionError(f"{name}: the library differs from numpy")
        row = ops.setdefault(name, dict(cases=0, cpp_ms=0.0, numpy_ms=0.0))
        row["cases"] += 1
        row["cpp_ms"] += best_ms(lambda: getattr(native, name)(*args), reps)
        row["numpy_ms"] += best_ms(
            lambda: getattr(augment.NumpyPixels, name)(*args), 1)

    src = host_picture(*HOST_SRC, seed=0)
    for scale in augment.COCO_SCALES:
        held("resize_bilinear", (src, *augment.rescale_size(*HOST_SRC,
                                                            scale)[:2]))
    view = native.resize_bilinear(src, *HOST_VIEW)
    h, w = HOST_VIEW
    c, t = ((w - 1) * 0.5, (h - 1) * 0.5), math.tan(math.radians(30))
    for t2x3 in (np.array([[1, 0, 0.1 * w], [0, 1, 0]]),
                 np.array([[1, 0, 0], [0, 1, -0.1 * h]]),
                 augment.rotation_matrix_2d(c, 30.0, 1.0),
                 augment.rotation_matrix_2d(c, -30.0, 1.0),
                 np.array([[1, t, 0], [0, 1, 0]]),
                 np.array([[1, 0, 0], [-t, 1, 0]])):
        held("warp_affine", (view, augment._inverse_affine(t2x3).astype(
            np.float32), augment.FILL))
    colour = {}
    for op in range(9):
        cpp = numpy_ms = 0.0
        for mag in range(1, 10):
            sample = augment.make_sample(view)
            t0 = time.perf_counter()
            got = augment.apply_color_op(OneOp(op, mag), sample).img
            cpp += time.perf_counter() - t0
            augment.px = augment.NumpyPixels
            try:
                t0 = time.perf_counter()
                ref = augment.apply_color_op(OneOp(op, mag), sample).img
                numpy_ms += time.perf_counter() - t0
            finally:
                augment.px = native
            if not np.array_equal(got, ref):
                raise AssertionError(f"colour op {op} magnitude {mag}: the "
                                     "library differs from numpy")
        colour[op] = dict(cpp_ms=cpp * 1e3 / 9, numpy_ms=numpy_ms * 1e3 / 9)
    # the PNG row filters: random rows under all five filter types
    rs = np.random.RandomState(1)
    rows = rs.randint(0, 256, (HOST_SRC[0], HOST_SRC[1] * 3 + 1)).astype(
        np.uint8)
    rows[:, 0] = np.arange(HOST_SRC[0]) % 5
    raw = rows.tobytes()
    args = (raw, HOST_SRC[0], HOST_SRC[1] * 3, 3)
    if not np.array_equal(native.png_unfilter(*args),
                          image_io._unfilter(*args)):
        raise AssertionError("PNG row filters: the library differs")
    ops["png_unfilter"] = dict(cases=1, cpp_ms=best_ms(
        lambda: native.png_unfilter(*args)), numpy_ms=best_ms(
        lambda: image_io._unfilter(*args), 1))
    cv2_formats = cv2_format_fixtures()
    blank_tiffs = blank_tiff_fixtures()
    jp2 = jp2_writes()
    avif = avif_writes()
    round_trip = jpeg_round_trips(route)
    damaged = damaged_jpegs()
    damaged.update(damaged_formats())
    jpg = native.encode_jpeg(src)
    png = image_io.encode_png(src)
    codec = dict(jpeg_encode_ms=best_ms(lambda: native.encode_jpeg(src)),
                 jpeg_decode_ms=best_ms(lambda: native.decode_image(jpg)),
                 jpeg_decode_backend_ms=best_ms(
                     lambda: native.decode_jpeg_backend(jpg)),
                 jpeg_check_ms=best_ms(lambda: native.jpeg_check(jpg)),
                 png_decode_ms=best_ms(lambda: native.decode_image(png)),
                 png_decode_numpy_ms=best_ms(
                     lambda: image_io.decode_png(png), 1),
                 jpeg_bytes=len(jpg))
    for name, row in ops.items():
        log(f"  {name:16s} {row['cases']:2d} cases bit-equal; ms per case: "
            f"C++ {row['cpp_ms'] / row['cases']:.3f}, numpy "
            f"{row['numpy_ms'] / row['cases']:.3f}")
    log("  colour ops, 9 magnitudes each bit-equal; ms per call at "
        f"{HOST_VIEW[0]}x{HOST_VIEW[1]} (C++ / numpy): " + ", ".join(
            f"{op}: {r['cpp_ms']:.2f} / {r['numpy_ms']:.2f}"
            for op, r in colour.items()))
    log(f"  {HOST_SRC[0]}x{HOST_SRC[1]} codecs (ms): " + ", ".join(
        f"{k} {v:.3f}" if k.endswith("ms") else f"{k} {v}"
        for k, v in codec.items()))
    return dict(probe=found, decoders=native.decoders(),
                build_s=host_build_s, fixtures=fixtures, formats=formats,
                cv2_formats=cv2_formats, blank_tiffs=blank_tiffs,
                jp2_writes=jp2, avif_writes=avif, ops=ops,
                colour_ops=colour, codecs=codec, round_trip=round_trip,
                damaged=damaged)


def fixture_names():
    """(JPEG fixtures by name: their kind and colour, PNG fixture names)
    of native/fixtures: every other kind of file the JAX package reads."""
    with open(os.path.join(native.FIXTURES, "jpeg_formats.json")) as f:
        jpegs = json.load(f)
    pngs = sorted(n[:-4] for n in os.listdir(native.FIXTURES)
                  if n.startswith("png_") and n.endswith(".png")
                  and not n.endswith(".ref.png"))
    return jpegs, pngs


def format_fixtures():
    """Each fixture of the other kinds decoded by the host library on the
    card against its committed pixels, at max abs 0: its kind, colour and
    route, ms per decode; nvJPEG's decode of each JPEG one printed beside
    it (or its refusal), not held."""
    jpegs, pngs = fixture_names()
    routes = native.decoders()
    out = {}
    for name, want in jpegs.items():
        jpg = os.path.join(native.FIXTURES, f"{name}.jpg")
        with open(jpg, "rb") as f:
            buf = f.read()
        ref = image_io.read_image(os.path.join(native.FIXTURES,
                                               f"{name}.png"))
        kind, colour = native.jpeg_host_kind(buf), native.jpeg_colour(buf)
        got = native.decode_image(buf, jpg)
        diff = np.abs(got.astype(int) - ref.astype(int)) \
            if got.shape == ref.shape else None
        row = out[name] = dict(
            kind=kind, colour=colour,
            route=routes.get("jpeg_" + str(kind).replace(" ", "_")),
            shape=list(got.shape),
            max_abs=None if diff is None else int(diff.max()),
            ms=best_ms(lambda: native.decode_image(buf)))
        try:
            back = native.decode_jpeg_backend(buf, jpg)
            bdiff = np.abs(back.astype(int) - ref.astype(int))
            row["backend"] = dict(max_abs=int(bdiff.max()),
                                  mean_abs=float(bdiff.mean()))
        except native.ImageDecodeError as err:
            row["backend"] = dict(refused=str(err).split(": ", 1)[-1])
        log(f"  fixture {name} ({kind}, {colour}; {row['route']}): max abs "
            f"{row['max_abs']}, {row['ms']:.3f} ms; the back end's decode "
            f"({routes['jpeg']}): {row['backend']}")
        if (kind, colour) != (want["kind"], want["colour"]) \
                or row["max_abs"] != 0:
            raise AssertionError(f"fixture {name}: {row}, want {want} at "
                                 "max abs 0")
    for name in pngs:
        path = os.path.join(native.FIXTURES, f"{name}.png")
        with open(path, "rb") as f:
            buf = f.read()
        ref = image_io.read_image(os.path.join(native.FIXTURES,
                                               f"{name}.ref.png"))
        got = native.decode_image(buf, path)
        plain = image_io.decode_png(buf)
        row = out[name] = dict(
            shape=list(got.shape), route=routes["png"],
            max_abs=int(np.abs(got.astype(int) - ref.astype(int)).max())
            if got.shape == ref.shape else None,
            numpy_equal=bool(np.array_equal(plain, got)),
            ms=best_ms(lambda: native.decode_image(buf)),
            numpy_ms=best_ms(lambda: image_io.decode_png(buf), 1))
        log(f"  fixture {name} (PNG): max abs {row['max_abs']}, "
            f"{row['ms']:.3f} ms (numpy {row['numpy_ms']:.3f} ms, equal "
            f"{row['numpy_equal']})")
        if row["max_abs"] != 0 or not row["numpy_equal"]:
            raise AssertionError(f"fixture {name}: {row}")
    return out


def cv2_format_fixtures():
    """The fixtures of the files the JAX loader hands to cv2
    (native/fixtures/formats.json): BMP, PNM, PAM, TIFF (with CCITT,
    BigTIFF, CMYK, YCbCr, signed samples; tiffx_*: square orientation 5-8,
    estimated StripByteCounts, CMYK inside JPEG, a predictor on subsampled
    YCbCr, CIELab, SGILog, ThunderScan), WebP, lossless JPEG, GIF, Sun
    raster, PFM, Radiance HDR and JPEG 2000 decoded by the host library on
    the card
    against their stored cv2 pixels at max abs 0, with ms per fixture (its
    variant beside it) and per format and the route, and a 480x640 Sun
    raster, PAM and PFM written by `tools.raw_formats` from the 480x640
    WebP fixture's cv2 reference (held to it); what cv2 refuses (12-bit
    JPEG, lossless it cannot convert, TIFF orientation 6 on a picture that
    is not square, LZMA, ZSTD and float TIFF, predictor 3 on integer
    samples, ICC CIELab, LogLuv without SGILog, RLE Sun raster, a one-
    channel PFM, old-style run-length HDR, signed, sub-sampled or offset
    JPEG 2000, ...) raises saying so, and what cv2 reads that the port
    does not would raise naming itself with "not ported" (no committed
    fixture does now)."""
    with open(os.path.join(native.FIXTURES, "formats.json")) as f:
        index = json.load(f)
    routes = native.decoders()
    rows, small, large = {}, {}, {}
    wide_ref = image_io.read_image(os.path.join(
        native.FIXTURES, "webp_lossless_480x640.ref.png"))
    built = {}
    for name, (buf, fmt, variant) in raw_format_files(wide_ref).items():
        built[name] = buf
        index[name] = {"format": fmt, "variant": variant, "expect": "pixels",
                       "route": {"Sun raster": "sun_raster", "PAM": "pam",
                                 "PFM": "pfm"}[fmt]}
    for name, want in sorted(index.items()):
        path = os.path.join(native.FIXTURES, name)
        if name in built:
            buf = built[name]
        else:
            with open(path, "rb") as f:
                buf = f.read()
        if want["expect"] != "pixels":
            text = ("not ported" if want["expect"] == "not ported"
                    else "cv2 refuses it too")
            try:
                native.decode_image(buf, path)
            except native.ImageDecodeError as err:
                if path not in str(err) or text not in str(err):
                    raise AssertionError(f"{name}: {err} (want '{text}')")
                rows[name] = dict(format=want["format"],
                                  expect=want["expect"],
                                  raised=str(err).split(": ", 1)[-1])
                log(f"  fixture {name} ({want['format']}, "
                    f"{want['expect']}) raises: {rows[name]['raised']}")
                continue
            raise AssertionError(f"{name}: decoded where it must raise "
                                 f"({want['expect']})")
        ref = wide_ref if name in built else image_io.read_image(
            os.path.join(native.FIXTURES, name.rsplit(".", 1)[0] + ".ref.png"))
        got = native.decode_image(buf, path)
        row = rows[name] = dict(
            format=want["format"], variant=want["variant"],
            route=routes[want["route"]], shape=list(got.shape),
            max_abs=int(np.abs(got.astype(int) - ref.astype(int)).max())
            if got.shape == ref.shape else None,
            bytes=len(buf), ms=best_ms(lambda: native.decode_image(buf)))
        (large if got.shape[0] * got.shape[1] >= 480 * 640 else small
         ).setdefault(want["format"], []).append(row["ms"])
        log(f"  fixture {name} ({want['format']}: {want['variant']}; "
            f"{want['route']}): max abs {row['max_abs']}, {row['ms']:.3f} ms")
        if row["max_abs"] != 0:
            raise AssertionError(f"fixture {name}: {row}, not cv2's pixels")
    per_format = {}
    for size, group in (("small", small), ("480x640", large)):
        for fmt, ms in sorted(group.items()):
            per_format[f"{fmt} {size}"] = dict(
                fixtures=len(ms), mean_ms=float(np.mean(ms)),
                max_ms=float(np.max(ms)))
    log("  ms per decode by format (fixtures; mean, max): " + ", ".join(
        f"{k} ({v['fixtures']}): {v['mean_ms']:.3f}, {v['max_ms']:.3f}"
        for k, v in per_format.items()))
    ht = {n: r for n, r in rows.items() if n.startswith("j2kh_")}
    ht_small = [r["ms"] for n, r in ht.items()
                if "ms" in r and n != HT_DEMO_FIXTURE]
    ht_sum = dict(fixtures=len(ht), max_abs_0=sum(
        r.get("max_abs") == 0 for r in ht.values()),
        refused=sum("raised" in r for r in ht.values()),
        small_mean_ms=float(np.mean(ht_small)),
        small_max_ms=float(np.max(ht_small)),
        ms_480x640=rows[HT_DEMO_FIXTURE]["ms"])
    if ht_sum["max_abs_0"] + ht_sum["refused"] != len(ht) or len(ht) < 27:
        raise AssertionError(f"HT fixtures: {ht_sum}")
    log(f"  high-throughput JPEG 2000 (j2kh_*): {ht_sum['fixtures']} "
        f"fixtures, {ht_sum['max_abs_0']} at max abs 0 and "
        f"{ht_sum['refused']} refused as cv2 refuses them; ms per decode "
        f"{ht_sum['small_mean_ms']:.3f} mean, {ht_sum['small_max_ms']:.3f} "
        f"max at 64x64 or less; the 480x640 HT file "
        f"{ht_sum['ms_480x640']:.3f} ms")
    return dict(fixtures=rows, per_format=per_format, ht=ht_sum,
                avif=avif_summary(rows))


def avif_summary(rows):
    """The avif_* fixtures of cv2_format_fixtures' rows: how many decoded
    at max abs 0, lossless and lossy, and how many raised as they must (a
    grid libavif refuses), the AV1 tools the decoder counted (each must
    have been reached), and the 480x640 lossless and lossy files' decodes
    on the calling thread (one core), ms, beside the card's name and power
    limit."""
    avif = {n: r for n, r in rows.items() if n.startswith(("avif_", "other_avif"))}
    lossy = [n for n in avif if n.startswith(("avif_lossy_", "other_avif"))]
    # several tiles, other writers' chroma layouts and colour descriptions
    others = [n for n in avif if n.startswith(AVIF_OTHER_PREFIXES)]
    big = (AVIF_FIXTURE, AVIF_LOSSY_FIXTURE) + AVIF_TILE_FIXTURES
    small = [r["ms"] for n, r in avif.items() if "ms" in r and n not in big]
    small_lossy = [avif[n]["ms"] for n in lossy if n not in big]
    tools = native.avif_tools()
    out = dict(fixtures=len(avif), max_abs_0=sum(
        r.get("max_abs") == 0 for r in avif.values()),
        lossy=len(lossy), lossy_max_abs_0=sum(
            avif[n].get("max_abs") == 0 for n in lossy),
        others=len(others), others_max_abs_0=sum(
            avif[n].get("max_abs") == 0 for n in others),
        raised=sum("raised" in r for r in avif.values()),
        small_mean_ms=float(np.mean(small)), small_max_ms=float(np.max(small)),
        small_lossy_mean_ms=float(np.mean(small_lossy)),
        small_lossy_max_ms=float(np.max(small_lossy)),
        ms_480x640=rows[AVIF_FIXTURE]["ms"],
        lossy_ms_480x640=rows[AVIF_LOSSY_FIXTURE]["ms"],
        tiles_ms={n: rows[n]["ms"] for n in AVIF_TILE_FIXTURES}, tools=tools)
    missed = [t for t, k in tools.items() if not k]
    if out["max_abs_0"] + out["raised"] != len(avif) or len(avif) < 69 \
            or out["lossy_max_abs_0"] != len(lossy) or len(lossy) < 21 \
            or out["others_max_abs_0"] != len(others) or len(others) < 24 \
            or missed:
        raise AssertionError(f"AVIF fixtures: {out}; tools not reached: "
                             f"{missed}")
    log(f"  AVIF (avif_*): {out['fixtures']} fixtures, {out['max_abs_0']} "
        f"at max abs 0 ({out['lossy_max_abs_0']} of them cv2's lossy: "
        f"4:2:0 BT.601, monochrome, 8-12 bits, speeds 0-10, qualities "
        f"0-99; {out['others_max_abs_0']} of several tiles, lossy 4:4:4 and "
        f"4:2:2, lossless 4:2:0 and 4:2:2, limited range, BT.709, BT.2020 "
        f"and the matrices libavif maps to them), "
        f"{out['raised']} raised (a grid cv2 refuses); ms per decode "
        f"{out['small_mean_ms']:.3f} mean, {out['small_max_ms']:.3f} max "
        f"below 480x640 (lossy {out['small_lossy_mean_ms']:.3f} mean, "
        f"{out['small_lossy_max_ms']:.3f} max); at 480x640 the lossless "
        f"file {out['ms_480x640']:.3f} ms, the lossy one (cv2's defaults) "
        f"{out['lossy_ms_480x640']:.3f} ms; several tiles " + ", ".join(
            f"{n} {ms:.3f} ms" for n, ms in out["tiles_ms"].items()) +
        f", on one core ({card_line()})")
    log("  AV1 tools decoded (blocks, or pictures): " + ", ".join(
        f"{t} {k}" for t, k in tools.items()))
    return out


def blank_tiff_fixtures():
    """The TIFF fixtures of the compressions cv2's libtiff cannot decode
    (tiffb_*: Pixar, NeXT, JPEG 2000 inside TIFF), which cv2 reads as the
    picture of zero samples: each decoded to one colour at its file's
    size (cv2_format_fixtures holds them to cv2's pixels)."""
    out = {}
    for name in sorted(n for n in os.listdir(native.FIXTURES)
                       if n.startswith("tiffb_") and n.endswith(".tif")):
        path = os.path.join(native.FIXTURES, name)
        with open(path, "rb") as f:
            got = native.decode_image(f.read(), path)
        colours = np.unique(got.reshape(-1, 3), axis=0)
        out[name] = dict(hw=list(got.shape[:2]),
                         colour=colours[0].tolist(), colours=len(colours))
        log(f"  blank TIFF {name}: {got.shape[0]}x{got.shape[1]}, "
            f"{len(colours)} colour {colours[0].tolist()}")
        if len(colours) != 1:
            raise AssertionError(f"{name}: not the picture of zero samples")
    if len(out) != 3:
        raise AssertionError(f"blank TIFF fixtures: {sorted(out)}")
    return out


def jp2_writes():
    """The library's JPEG 2000 encoder (OpenJPEG 2.5.3's reversible encoder
    cut to cv2's rate 4, `native.encode_jp2`) on this machine's compiler:
    each committed picture (native/fixtures/jp2_writes.json: PNG) against
    cv2's committed .jp2, host_picture at 480x640 and 800x1344 against the
    length and sha256 of cv2's file, each file read back through the
    library's decoder; encode and decode ms; cv2's refusal below 32 pixels
    (its 77-byte file)."""
    with open(os.path.join(native.FIXTURES, "jp2_writes.json")) as f:
        spec = json.load(f)
    rows = {}

    def held(name, img, want_len, want_sha):
        got = native.encode_jp2(img)
        back = native.decode_image(got)
        row = rows[name] = dict(
            hw=list(img.shape[:2]), bytes=len(got),
            equal=(len(got), hashlib.sha256(got).hexdigest()) == (
                want_len, want_sha),
            readback_max_abs=int(np.abs(back.astype(int) - img).max()),
            encode_ms=best_ms(lambda: native.encode_jp2(img)),
            decode_ms=best_ms(lambda: native.decode_image(got)))
        log(f"  jp2 write {name} {img.shape[0]}x{img.shape[1]}: {len(got)} "
            f"bytes, cv2's {row['equal']}, reads back at max abs "
            f"{row['readback_max_abs']}; encode {row['encode_ms']:.3f} ms, "
            f"decode {row['decode_ms']:.3f} ms")
        if not row["equal"]:
            raise AssertionError(f"jp2 write {name}: not cv2's bytes")

    for name, files in sorted(spec["pictures"].items()):
        img = image_io.read_image(os.path.join(native.FIXTURES, files["png"]))
        with open(os.path.join(native.FIXTURES, files["jp2"]), "rb") as f:
            want = f.read()
        held(name, img, len(want), hashlib.sha256(want).hexdigest())
    for row in spec["host_pictures"]:
        held(f"host_picture_{row['h']}x{row['w']}",
             host_picture(row["h"], row["w"], row["seed"]), row["bytes"],
             row["sha256"])
    try:
        native.encode_jp2(host_picture(31, 40, 0))
        raise AssertionError("jp2 write 31x40: not refused")
    except native.EncodeRefused as err:
        if len(err.partial) != 77:
            raise AssertionError(f"jp2 write 31x40: {len(err.partial)} "
                                 "bytes left, cv2 leaves 77")
        refusal = err.reason
    log(f"  jp2 write 31x40 refused as cv2 refuses it: {refusal}")
    return dict(files=rows, refusal=refusal)


def avif_writes():
    """The library's AVIF encoder (cv2.imwrite's defaults, the library's
    own tile: `native.encode_avif`) on this machine's compiler: each
    picture of native/fixtures/avif_writes.json (host_picture at 480x640,
    800x1344 and the edge sizes 1x1, 2x3, 45x61, 65x129; the jp2w_*.png
    pictures; a render.json render) encoded once, held to the committed
    length and sha256 the sandbox's compiler wrote, and read back through
    the library's decoder to the committed decode's sha256; encode ms of
    each (decode ms at the two photo sizes); and a picture wider than 4096
    (AVIF_TILE_WRITE, 2x1 tiles), read back to the encoder's reconstruction,
    its encode and decode ms."""
    with open(os.path.join(native.FIXTURES, "avif_writes.json")) as f:
        spec = json.load(f)
    rows, failures = {}, []
    for want in spec["pictures"]:
        name = want["name"]
        if name.startswith("host_picture_"):
            img = host_picture(want["h"], want["w"], 0)
        else:
            img = image_io.read_image(os.path.join(native.FIXTURES, name))
        t0 = time.perf_counter()
        got = native.encode_avif(img)
        encode_ms = (time.perf_counter() - t0) * 1e3
        back = native.decode_image(got, name)
        row = rows[name] = dict(
            hw=list(img.shape[:2]), bytes=len(got), encode_ms=encode_ms,
            equal=(len(got), hashlib.sha256(got).hexdigest()) == (
                want["bytes"], want["sha256"]),
            decode_equal=hashlib.sha256(back.tobytes()).hexdigest() ==
            want["decode_sha256"])
        if img.shape[0] * img.shape[1] >= 480 * 640:
            row["decode_ms"] = best_ms(lambda: native.decode_image(got))
        log(f"  avif write {name} {img.shape[0]}x{img.shape[1]}: "
            f"{len(got)} bytes, the sandbox's {row['equal']}, decode the "
            f"committed one {row['decode_equal']}; encode "
            f"{encode_ms:.1f} ms" + (f", decode {row['decode_ms']:.2f} ms"
                                     if "decode_ms" in row else ""))
        if not (row["equal"] and row["decode_equal"]):
            failures.append(name)
    # several tiles: the encoder's file read back to its reconstruction
    # (the decoder's planes, counted as several tiles by the tally)
    h, w = AVIF_TILE_WRITE
    img = host_picture(h, w, 0)
    t0 = time.perf_counter()
    got, recon = native.avif_encode_planes(img)
    encode_ms = (time.perf_counter() - t0) * 1e3
    before = native.avif_tools()["tiles"]
    t0 = time.perf_counter()
    planes = native.avif_planes(got, "all")
    decode_ms = (time.perf_counter() - t0) * 1e3
    row = rows[f"host_picture_{h}x{w}_tiles"] = dict(
        hw=[h, w], bytes=len(got), encode_ms=encode_ms, decode_ms=decode_ms,
        several_tiles=native.avif_tools()["tiles"] > before,
        reads_back=all(np.array_equal(a, b) for a, b in zip(recon, planes)))
    log(f"  avif write host_picture {h}x{w} (several tiles): {len(got)} "
        f"bytes, several tiles {row['several_tiles']}, reads back to the "
        f"encoder's reconstruction {row['reads_back']}; encode "
        f"{encode_ms:.1f} ms, decode {decode_ms:.2f} ms ({card_line()})")
    if not (row["several_tiles"] and row["reads_back"]):
        failures.append(f"host_picture_{h}x{w}_tiles")
    if failures:
        raise AssertionError(f"avif write: not the sandbox's bytes or "
                             f"decode: {failures}")
    return rows


def damaged_formats():
    """Damaged copies of the cv2-format fixtures, each decoded under its
    own file name: BMP, PNM, PAM, TIFF (LZW, Group 4, BigTIFF, CIELab, CMYK
    inside JPEG), lossless
    JPEG, GIF, Sun raster, PFM, HDR, JPEG 2000 (JP2, a raw codestream,
    PPM headers, high-throughput code-blocks) and AVIF (lossless, intra
    block copy, lossy) cut in half, a codestream
    without its EOC and one whose tile-part length runs past its end, an
    HT codestream whose Scup runs past its cleanup segment, a WebP cut in
    half with its RIFF size made consistent (its VP8 chunk then runs past
    the file), a
    VP8L one with its codes overwritten, a GIF of LZW codes past its table
    and a Group 4 strip of EOLs where its 2-D codes belong. Each must raise
    ImageDecodeError naming the file. An LZW strip of codes past its table
    must read to a picture of the file's size, as cv2 reads it (its pixels
    held to cv2's by the CPU tests)."""
    def fixture(name):
        with open(os.path.join(native.FIXTURES, name), "rb") as f:
            return f.read()
    cases = {}
    for name in ("bmp_24.bmp", "pnm_p6_100.ppm", "tiff_lzw_predictor.tif",
                 "jpeg_lossless_p8.jpg", "gif_480x640.gif", "ras_pal8.ras",
                 "pam_rgb16.pam", "pfm_scale2_be.pfm", "hdr_480x640.hdr",
                 "tiffv_g4_480x640.tif", "tiffv_bigtiff.tif",
                 "tiffx_cielab_480x640.tif", "tiffx_cmyk_jpeg.tif",
                 "j2k_480x640_lossless.jp2", "j2k_raw.j2k",
                 "j2kw_ppm.j2k", HT_DEMO_FIXTURE, AVIF_FIXTURE,
                 "avif_intrabc.avif", AVIF_LOSSY_FIXTURE):
        buf = fixture(name)
        stem, ext = name.rsplit(".", 1)
        cases[f"{stem}_truncated.{ext}"] = buf[:len(buf) // 2]
    webp = bytearray(fixture("webp_lossy.webp"))
    webp = webp[:len(webp) // 2]
    webp[4:8] = (len(webp) - 8).to_bytes(4, "little")
    cases["webp_lossy_cut.webp"] = bytes(webp)
    vp8l = bytearray(fixture("webp_lossless.webp"))
    vp8l[40:60] = b"\xff" * 20
    cases["webp_lossless_bad_codes.webp"] = bytes(vp8l)
    gif = bytearray(fixture("gif_480x640.gif"))
    gif[-2000:-1980] = b"\xff" * 20
    cases["gif_bad_codes.gif"] = bytes(gif)
    g4 = bytearray(fixture("tiffv_g4_480x640.tif"))
    at = int.from_bytes(g4[4:8], "little")  # Pillow writes the IFD first
    strip = next(int.from_bytes(g4[p + 8:p + 12], "little")
                 for p in range(at + 2, at + 2 + 12 * int.from_bytes(
                     g4[at:at + 2], "little"), 12)
                 if int.from_bytes(g4[p:p + 2], "little") == 273)
    g4[strip:strip + 16] = b"\0\0\0\x01" * 4
    cases["tiffv_g4_bad_codes.tif"] = bytes(g4)
    j2k = fixture("j2k_raw.j2k")
    cases["j2k_raw_no_eoc.j2k"] = j2k[:-2]
    sot = j2k.find(b"\xff\x90")
    cases["j2k_raw_psot_past_end.j2k"] = j2k[:sot + 6] + (
        len(j2k)).to_bytes(4, "big") + j2k[sot + 10:]
    ht = raw_formats._picture(13, 19, 51, 60)
    cases["j2kh_scup_past_lcup.j2k"] = raw_formats.j2k_codestream(
        [ht[..., c] for c in range(3)], ht=True, ht_passes=3,
        ht_damage="scup_past_lcup")
    out = {}
    for name, data in cases.items():
        try:
            native.decode_image(data, name)
        except native.ImageDecodeError as err:
            if name not in str(err):
                raise AssertionError(f"{name}: the error does not name the "
                                     f"file: {err}")
            out[name] = str(err)
            log(f"  {name} copy raises: {err}")
            continue
        raise AssertionError(f"{name}: decoded without an error")
    # LZW codes garbled inside a strip: cv2 reads a picture (libtiff's RGBA
    # reader goes on with what the codec wrote), and so does the library;
    # the CPU tests hold its pixels to cv2's
    lzw = bytearray(fixture("tiff_lzw_predictor.tif"))
    lzw[8:40] = b"\xff" * 32
    garbled = native.decode_image(bytes(lzw), "tiff_bad_lzw.tif")
    want = native.decode_image(fixture("tiff_lzw_predictor.tif"))
    if garbled.shape != want.shape:
        raise AssertionError(f"tiff_bad_lzw.tif: {garbled.shape}, not "
                             f"{want.shape}")
    out["tiff_bad_lzw.tif"] = (f"reads as cv2 reads it: {garbled.shape}, "
                               f"{int((garbled != want).any(-1).sum())} "
                               "pixels off the intact file's")
    log(f"  tiff_bad_lzw.tif copy {out['tiff_bad_lzw.tif']}")
    return out


def jpeg_round_trips(route):
    """The library's JPEG encode and decode of each picture of the
    committed cv2 reference (native/fixtures/cv2_q95_roundtrip.json),
    against cv2's quality-95 round trip of the same picture: equal on the
    libjpeg route (the same library, the same settings), within
    ROUND_TRIP_SLACK on the nvJPEG route."""
    with open(os.path.join(native.FIXTURES, "cv2_q95_roundtrip.json")) as f:
        refs = json.load(f)["pictures"]
    pics = {}
    for name in ("colour_420", "gray"):
        with open(os.path.join(native.FIXTURES, f"{name}.png"), "rb") as f:
            pics[name] = image_io.decode_png(f.read())
    pics["noise_480x640"] = host_picture(*HOST_SRC, seed=0)
    out = {}
    for name, pic in pics.items():
        back = native.decode_image(native.encode_jpeg(pic))
        diff = np.abs(back.astype(int) - pic.astype(int))
        ref = refs[name]
        row = out[name] = dict(max_abs=int(diff.max()),
                               mean_abs=float(diff.mean()),
                               cv2_max_abs=ref["max_abs"],
                               cv2_mean_abs=ref["mean_abs"])
        log(f"  JPEG round trip {name} ({route}): max abs {row['max_abs']}, "
            f"mean abs {row['mean_abs']:.4f}; cv2 quality 95: "
            f"{ref['max_abs']}, {ref['mean_abs']:.4f}")
        if route == "libjpeg":
            ok = (row["max_abs"] == ref["max_abs"]
                  and math.isclose(row["mean_abs"], ref["mean_abs"],
                                   rel_tol=1e-12))
        else:
            ok = (row["max_abs"] <= ref["max_abs"] + ROUND_TRIP_SLACK[0]
                  and row["mean_abs"] <= ref["mean_abs"]
                  + ROUND_TRIP_SLACK[1])
        if back.shape != pic.shape or not ok:
            raise AssertionError(f"JPEG round trip {name}: {row} beyond cv2's "
                                 f"with slack {ROUND_TRIP_SLACK} ({route})")
    return out


def damaged_jpegs():
    """Damaged copies of the fixtures, each decoded under its own file
    name: the colour one truncated, and each with a run of 64 one bits in
    its entropy-coded data (no Huffman code is all ones; nvJPEG decodes
    both without complaint, the library's checks catch them), the
    progressive arithmetic one truncated, and the Adam7 PNG with a byte of
    its data flipped (a bad CRC). Each must raise ImageDecodeError naming
    the file."""
    cases = {}
    for name in ("colour_420", "gray"):
        with open(os.path.join(native.FIXTURES, f"{name}.jpg"), "rb") as f:
            buf = f.read()
        sos = buf.index(b"\xff\xda")
        mid = (sos + 2 + (buf[sos + 2] << 8 | buf[sos + 3]) + len(buf)
               - 2) // 2
        if name == "colour_420":
            cases[f"{name}_truncated"] = buf[:mid]
        cases[f"{name}_bad_code"] = buf[:mid] + b"\xff\x00" * 8 \
            + buf[mid + 16:]
    with open(os.path.join(native.FIXTURES, "jpeg_arith_progressive.jpg"),
              "rb") as f:
        buf = f.read()
    cases["arith_progressive_truncated"] = buf[:len(buf) // 2]
    with open(os.path.join(native.FIXTURES, "png_rgb_adam7.png"), "rb") as f:
        png = bytearray(f.read())
    png[60] ^= 0xFF                                    # inside IDAT
    cases["png_adam7_damaged"] = bytes(png)
    out = {}
    for kind, data in cases.items():
        name = f"{kind}.png" if kind.startswith("png") else f"{kind}.jpg"
        try:
            native.decode_image(data, name)
        except native.ImageDecodeError as err:
            if name not in str(err):
                raise AssertionError(f"{kind}: the error does not name the "
                                     f"file: {err}")
            out[kind] = str(err)
            log(f"  {kind} copy raises: {err}")
            continue
        raise AssertionError(f"{name}: decoded without an error")
    return out


def augment_ms(dataset, n_synthetic, reps=16):
    """Host ms per weak and per strong view of the set's images at the
    recipe's 11 scales (the prefetch worker's work per view), with the
    pixel work of the host library and of the numpy plain versions (the
    same draws), and ms per image decode (read_image) of its first
    n_synthetic images (the synthetic set's, before the fixtures)."""
    imgs = [dataset.load_image(i) for i in range(4)]
    out = {}
    for pixels, label in ((native, "cpp"), (augment.NumpyPixels, "numpy")):
        augment.px = pixels
        try:
            rng = np.random.default_rng(0)
            for name, fn in (("weak", augment.weak_augment),
                             ("strong", augment.strong_augment)):
                t0 = time.perf_counter()
                for r in range(reps):
                    fn(rng, augment.make_sample(imgs[r % len(imgs)]))
                out.setdefault(name, {})[label] = (
                    time.perf_counter() - t0) / reps * 1e3
        finally:
            augment.px = native
    t0 = time.perf_counter()
    for i in range(n_synthetic):
        dataset.load_image(i)
    out["decode_per_image"] = (time.perf_counter() - t0) / n_synthetic * 1e3
    return out


def add_format_fixtures(paths, img_dir):
    """The committed fixtures of every other kind the JAX package reads
    (native/fixtures: JPEG by jpeg_formats.json, png_*.png, and one of each
    format the JAX loader hands to cv2, TRAINER_CV2_FIXTURES) copied into
    the synthetic set's image directory and appended, without boxes, to its
    unlabelled and val annotation files, so the trainer's data path
    (load_image) and eval (the prefetch loader) read them. Returns their
    file names."""
    jpegs, pngs = fixture_names()
    files = [f"{n}.jpg" for n in sorted(jpegs)] + [f"{n}.png" for n in pngs]
    files += list(TRAINER_CV2_FIXTURES)
    entries = []
    for i, name in enumerate(files):
        shutil.copy(os.path.join(native.FIXTURES, name), img_dir)
        with open(os.path.join(img_dir, name), "rb") as f:
            h, w = native.image_size(f.read(), name)
        entries.append({"id": 10 ** 6 + i, "file_name": name, "width": w,
                        "height": h})
    for split in ("unsup", "val"):
        with open(paths[split]) as f:
            coco = json.load(f)
        coco["images"] += entries
        with open(paths[split], "w") as f:
            json.dump(coco, f)
    return files


def quiet_steps(trainer):
    """{stage: ms of QUIET_STEPS steps} of the trainer's own step functions
    (warm-up, then Hungarian) on its own next batches, all built
    beforehand, so no prefetch thread works beside them: the step on the
    trainer's data without the host data path running (the state trains
    on; the resume below reads the checkpoint)."""
    gen = trainer.batches(start_step=trainer.state.step)
    out = {}
    for stage, warm_up in (("warm_up", True), ("hungarian", False)):
        hosts = [trainer._host_batch(next(gen))[0]
                 for _ in range(QUIET_STEPS)]
        step_fn = trainer._get_step(warm_up)
        out[stage] = []
        for host in hosts:
            batch = to_device(host, trainer.device, non_blocking=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(trainer.state, batch)
            torch.cuda.synchronize()
            out[stage].append((time.perf_counter() - t0) * 1e3)
    return out


def trainer_phase(card, bare_ms):
    log("== phase 7: trainer path (SSOD CLI at full width from COCO files: "
        "4 steps, eval, checkpoints, resume; eval CLI; supervised CLI)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        return run_trainers(card, tmp, bare_ms), tmp
    except BaseException:
        shutil.rmtree(tmp)
        raise


def trainer_classes():
    """Phase 7's class list (TRAINER_RENAMED, TRAINER_CLASSES_SEED)."""
    with open(os.path.join(native.FIXTURES, "render.json")) as f:
        case, = [c for c in json.load(f)["cases"] if c["name"] == "names"]
    names = [n for n in case["classes"] if n.isprintable()]
    rng = np.random.default_rng(TRAINER_CLASSES_SEED)
    where = [0] + sorted(int(i) for i in rng.choice(
        np.arange(1, len(COCO_CLASSES)), TRAINER_RENAMED - 1, replace=False))
    classes = list(COCO_CLASSES)
    for k, i in enumerate(where):
        classes[i] = names[k % len(names)] + (
            f" {k // len(names) + 1}" if k >= len(names) else "")
    return tuple(classes)


def run_trainers(card, tmp, bare_ms):
    n_img = max(max(r) for r in TRAINER_SPLITS.values()) + 1
    classes = trainer_classes()
    t0 = time.perf_counter()
    paths, img_dir = write_synthetic_coco(
        tmp, n=n_img, seed=0, splits=TRAINER_SPLITS,
        **dict(TRAINER_SET, class_name=classes[0]))
    names = sorted(os.listdir(img_dir))
    if len(names) != n_img or not all(n.endswith(".jpg") for n in names):
        raise AssertionError(f"synthetic set: {names[:4]} ...")
    added = add_format_fixtures(paths, img_dir)
    log(f"  wrote {n_img} JPEG images ({native.decoders()['jpeg']}) and "
        f"{len(paths)} annotation files in {time.perf_counter() - t0:.1f} s;"
        f" the {len(added)} format fixtures copied among the unlabelled and "
        f"val images: {added}")
    data_opts = [f"data.train_sup_ann={paths['sup']}",
                 f"data.train_unsup_ann={paths['unsup']}",
                 f"data.val_ann={paths['val']}",
                 f"data.train_prefix={img_dir}", f"data.val_prefix={img_dir}",
                 f"data.classes={list(classes)!r}"]
    log(f"  data.classes: the COCO names with {TRAINER_RENAMED} replaced: "
        + ", ".join(f"{i}: {n}" for i, n in enumerate(classes)
                    if n != COCO_CLASSES[i]))
    work = os.path.join(tmp, "ssod")
    ssod_args = [SSOD_CONFIG, "--work-dir", work, "--cfg-options",
                 *data_opts, f"ssod.warm_up_step={TRAINER_WARM_UP}",
                 f"eval_interval={TRAINER_INTERVAL}",
                 f"ckpt_interval={TRAINER_STEPS}",
                 f"image_log_interval={TRAINER_INTERVAL}",
                 f"ssod.score_thr={TRAINER_SCORE_THR}"]

    # per-step launch counts, eval and checkpoint times: the trainer's own
    # methods, wrapped for the length of this phase
    per_step, evals, saves, step_ms = [], [], [], {}
    run_step, evaluate = SsodTrainer._run_step, SsodTrainer.evaluate
    maybe_save = ckpt_mod.CheckpointManager.maybe_save

    def counted_step(self, step, batch, vis_img):
        # timed as phase 6 times a step: host clock around the step and a
        # synchronise (the trainer itself does not wait for the device)
        f0 = msda.ms_deform_attn_cuda.launches
        b0 = msda.ms_deform_attn_bwd_cuda.launches
        t0 = time.perf_counter()
        out = run_step(self, step, batch, vis_img)
        torch.cuda.synchronize()
        step_ms[step] = (time.perf_counter() - t0) * 1e3
        per_step.append((step, msda.ms_deform_attn_cuda.launches - f0,
                         msda.ms_deform_attn_bwd_cuda.launches - b0))
        return out

    def timed_eval(self, step, warm_up):
        f0 = msda.ms_deform_attn_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(self, step, warm_up)
        evals.append(dict(step=step, s=time.perf_counter() - t0,
                          launches=msda.ms_deform_attn_cuda.launches - f0,
                          images=len(self.val_dataset)))
        return out

    def timed_save(self, state, force=False):
        t0 = time.perf_counter()
        saved = maybe_save(self, state, force)
        if saved:
            saves.append(dict(step=state.step, s=time.perf_counter() - t0,
                              bytes=os.path.getsize(self.path(state.step))))
        return saved

    # the labels the trainer's pseudo renders draw, by route
    vis_routes = {way: 0 for way in text.ROUTES}
    vis_put_text = port_logging.put_text

    def recording_put_text(img, label, org, color):
        vis_routes[label_route(label)] += 1
        return vis_put_text(img, label, org, color)

    SsodTrainer._run_step, SsodTrainer.evaluate = counted_step, timed_eval
    ckpt_mod.CheckpointManager.maybe_save = timed_save
    port_logging.put_text = recording_put_text
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_detr_ssod.main(
            ssod_args + ["--max-steps", str(TRAINER_STEPS)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        fwd = msda.ms_deform_attn_cuda.launches
        bwd = msda.ms_deform_attn_bwd_cuda.launches
        assert_vector(msda.ms_deform_attn_cuda, "trainer forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda, "trainer backward")
        peak = torch.cuda.max_memory_allocated()
        steps_run = [t["step"] for t in trainer.timings]
        if steps_run != list(range(TRAINER_STEPS)):
            raise AssertionError(f"steps run: {steps_run}")
        for step, f, b in per_step:
            want = SSOD_LAUNCHES[step < TRAINER_WARM_UP]
            if (f, b) != want:
                raise AssertionError(f"trainer step {step}: {f} forward and "
                                     f"{b} backward MSDA launches, not {want}")
        # eval batches per aspect group (a portrait fixture, turned by its
        # EXIF orientation, makes a portrait batch of its own)
        flags = np.asarray(trainer.val_dataset.flags)
        n_batches = sum(-(-int((flags == f).sum()) // EVAL_BATCH)
                        for f in (0, 1))
        for e in evals:
            # teacher and student: 12 forward launches per eval batch
            if e["launches"] != 2 * n_batches * 12:
                raise AssertionError(f"eval at step {e['step']}: "
                                     f"{e['launches']} launches, not "
                                     f"{2 * n_batches * 12}")
        want_fwd = sum(f for _, f, _ in per_step) + sum(
            e["launches"] for e in evals)
        want_bwd = sum(b for _, _, b in per_step)
        if (fwd, bwd) != (want_fwd, want_bwd) or not evals:
            raise AssertionError(f"trainer run: {fwd} forward / {bwd} "
                                 f"backward launches, evals {evals}")
        ckpts = trainer.ckpt.all_steps()
        if ckpts != [TRAINER_STEPS]:
            raise AssertionError(f"checkpoints on disk: {ckpts}")
        evals_logged = read_evals(os.path.join(work, "train.log"))
        for tag in ("teacher", "student"):
            if (tag, TRAINER_INTERVAL) not in evals_logged:
                raise AssertionError(f"no Eval[{tag}] line at step "
                                     f"{TRAINER_INTERVAL}")
            check_aps(evals_logged[(tag, TRAINER_INTERVAL)], f"Eval[{tag}]")
        with open(os.path.join(work, "metrics.jsonl")) as f:
            first = json.loads(f.readline())
        if first["step"] != 0 or not math.isfinite(first["total_loss"]):
            raise AssertionError(f"metrics.jsonl starts with {first}")
        for step in (0, TRAINER_INTERVAL):
            vis = os.path.join(work, "pseudo_vis", f"step_{step}.jpg")
            if not os.path.isfile(vis) or image_io.read_image(vis).ndim != 3:
                raise AssertionError(f"no pseudo render at step {step}")
        log(f"  pseudo renders (steps 0 and {TRAINER_INTERVAL}): labels by "
            f"route {vis_routes}")
        if not sum(vis_routes.values()):
            raise AssertionError("the pseudo renders drew no label at "
                                 f"score_thr {TRAINER_SCORE_THR}")
        timings = trainer.timings
        val_dataset, unsup = trainer.val_dataset, trainer.unsup_dataset
        quiet = quiet_steps(trainer)
        del trainer
        torch.cuda.empty_cache()

        # resume: the run goes on from the last checkpoint for one step
        reset_counts()
        resumed = train_detr_ssod.main(
            ssod_args + ["--max-steps", str(TRAINER_STEPS + 1)])
        with open(os.path.join(work, "train.log")) as f:
            resumed_line = f"resumed from step {TRAINER_STEPS}" in f.read()
        if (not resumed_line or [t["step"] for t in resumed.timings]
                != [TRAINER_STEPS]):
            raise AssertionError(f"resume: log line {resumed_line}, steps "
                                 f"{[t['step'] for t in resumed.timings]}")
        del resumed
        torch.cuda.empty_cache()
    finally:
        SsodTrainer._run_step, SsodTrainer.evaluate = run_step, evaluate
        ckpt_mod.CheckpointManager.maybe_save = maybe_save
        port_logging.put_text = vis_put_text

    # the eval CLI on the last checkpoint, on the teacher (the default)
    t0 = time.perf_counter()
    res = test_cli.main([SSOD_CONFIG, "--work-dir", work, "--cfg-options",
                         *data_opts])
    test_s = time.perf_counter() - t0
    check_aps(res, "eval CLI")
    if not math.isfinite(res["mAP"]):
        raise AssertionError(f"eval CLI mAP {res['mAP']}")

    # the supervised CLI: 2 steps of batch 2 from the labelled set
    reset_counts()
    od = train_detr_od.main([
        CONFIG, "--work-dir", os.path.join(tmp, "od"), "--max-steps",
        str(OD_STEPS), "--cfg-options", f"data.train_ann={paths['sup']}",
        "data.val_ann=", f"data.train_prefix={img_dir}",
        f"data.classes={list(classes)!r}",
        f"schedule.batch_size={OD_BATCH}"])
    od_launches = (msda.ms_deform_attn_cuda.launches,
                   msda.ms_deform_attn_bwd_cuda.launches)
    if (od_launches != (12 * OD_STEPS, 12 * OD_STEPS)
            or [t["step"] for t in od.timings] != list(range(OD_STEPS))
            or od.ckpt.all_steps() != [OD_STEPS]):
        raise AssertionError(f"supervised CLI: launches {od_launches}, steps "
                             f"{od.timings}, ckpts {od.ckpt.all_steps()}")
    assert_vector(msda.ms_deform_attn_cuda, "supervised CLI forward")
    od_timings = od.timings
    del od
    torch.cuda.empty_cache()

    aug = augment_ms(unsup, len(TRAINER_SPLITS["unsup"]))
    eval_ms = [e["s"] * 1e3 / (2 * e["images"]) for e in evals]
    wait_ms = [t["data_wait_s"] * 1e3 for t in timings]
    # step 0 of each stage carries its first-call costs; the second is warm
    warm = {stage: float(np.median([step_ms[k] for k in ks]))
            for stage, ks in TRAINER_WARM.items()}
    log(f"  SSOD CLI: {TRAINER_STEPS} steps ({TRAINER_WARM_UP} warm-up) in "
        f"{run_s:.1f} s with eval and checkpoints; MSDA launches per step "
        f"{[(f, b) for _, f, b in per_step]}, per eval {evals[0]['launches']}"
        f" ({len(val_dataset)} images, teacher and student)")
    log(f"  warm step ms (host clock around the step and a synchronise, "
        f"median of steps {TRAINER_WARM['warm_up']} / "
        f"{TRAINER_WARM['hungarian']}): warm-up {warm['warm_up']:.1f}, "
        f"Hungarian "
        f"{warm['hungarian']:.1f}, against phase 6's bare step "
        f"{bare_ms['warm_up']:.1f} / {bare_ms['hungarian']:.1f} in this "
        f"call; train.data_wait ms per step "
        f"{[round(w, 1) for w in wait_ms]}")
    log("  the same steps on the trainer's next batches, built beforehand "
        "(no prefetch thread beside them), ms: " + "; ".join(
            f"{stage} {[round(q, 1) for q in ms]}, median "
            f"{float(np.median(ms)):.1f}" for stage, ms in quiet.items()))
    log(f"  augmentation ms per view at the 11 COCO scales (host library "
        f"/ numpy plain versions): weak {aug['weak']['cpp']:.1f} / "
        f"{aug['weak']['numpy']:.1f}, strong {aug['strong']['cpp']:.1f} / "
        f"{aug['strong']['numpy']:.1f}; decode {aug['decode_per_image']:.2f}"
        f" ms per {TRAINER_SET['hw'][0]}x{TRAINER_SET['hw'][1]} JPEG")
    log(f"  eval ms per image per model {[round(e, 1) for e in eval_ms]}; "
        f"eval CLI {test_s:.1f} s, teacher mAP {res['mAP']:.4f}")
    log("  checkpoint saves (step, s, bytes) "
        f"{[(c['step'], round(c['s'], 2), c['bytes']) for c in saves]}; "
        f"peak device memory {peak / 2 ** 30:.2f} GiB")
    log(f"  supervised CLI: {OD_STEPS} steps of batch {OD_BATCH}, step s "
        f"{[round(t['step_s'], 3) for t in od_timings]}")
    log("  " + card)
    return dict(steps=timings, launches_per_step=per_step, evals=evals,
                step_ms=step_ms, warm_step_ms=warm, bare_step_ms=bare_ms,
                quiet_step_ms=quiet,
                data_wait_ms=wait_ms,
                augment_ms=aug,
                eval_ms_per_image=eval_ms, checkpoint_saves=saves,
                peak_memory_bytes=peak, run_s=run_s, eval_cli_s=test_s,
                eval_cli=res, od_steps=od_timings, vis_routes=vis_routes,
                classes=[n for i, n in enumerate(classes)
                         if n != COCO_CLASSES[i]],
                launches_fwd=fwd, launches_bwd=bwd, card=card)



# --------------------------------------------------------------------------
# phase 7r: the render on the card's host
# --------------------------------------------------------------------------

def render_phase(card, trainer_dir):
    """Phase 7r: `save_result` against cv2's committed renders, then the
    image demo on phase 7's checkpoint. Returns the readings."""
    log("== phase 7r: the render on the card's host (save_result against "
        "cv2 5.0's committed renders; the image demo on phase 7's "
        "checkpoint, each file in its input's format)")
    failures = []
    with open(os.path.join(native.FIXTURES, "render.json")) as f:
        spec = json.load(f)
    # the fonts' costs, once per process: the fallback font's inflate and
    # parse, then the rasterisation of every glyph the cases draw
    text.glyph.cache_clear()
    text.fallback.cache_clear()
    t0 = time.perf_counter()
    text.fallback()
    fallback_ms = (time.perf_counter() - t0) * 1e3
    drawn = sorted({ch for case in spec["cases"]
                    for name in case.get("classes", COCO_CLASSES)
                    for ch in name + ":0123456789."} - {"\n", "\0"})
    t0 = time.perf_counter()
    for ch in drawn:
        text.glyph(ch)
    raster_ms = (time.perf_counter() - t0) * 1e3
    by_route = {way: [] for way in text.ROUTES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_render_")
    cases = []
    try:
        for case in spec["cases"]:
            img = host_picture(case["h"], case["w"], case["seed"])
            result = (np.asarray(case["boxes"], np.float32),
                      np.asarray(case["scores"], np.float32),
                      np.asarray(case["labels"], np.int64))
            thr = case["score_thr"]
            classes = tuple(case.get("classes", COCO_CLASSES))
            ref = image_io.read_image(os.path.join(native.FIXTURES,
                                                   case["ref"]))
            out = os.path.join(tmp, case["ref"])
            image_ms = best_ms(lambda: save_result(
                img, result, classes, out, score_thr=thr))
            got = image_io.read_image(out)
            held = render_check.hold(got, ref, img, result, classes, thr)
            box_abs, r = held["box_max_abs"], held["label"]
            labels = [(render_check.label_text(classes[int(lab)], s),
                       (int(b[0]), max(int(b[1]) - 4, 0)))
                      for b, s, lab in zip(*result) if s >= thr]
            canvas = img.copy()

            def draw_labels():
                for t, org in labels:
                    text.put_text(canvas, t, org, render_check.COLOUR)
            label_ms = best_ms(draw_labels) / len(labels)
            for t, org in labels:
                way = label_route(t)
                by_route[way].append(best_ms(lambda: text.put_text(
                    canvas, t, org, render_check.COLOUR)))
            if "classes" in case and not np.array_equal(got, ref):
                failures.append(f"render {case['name']}: not cv2's pixels "
                                f"(labels {r})")
            if not held["ok"]:
                failures.append(f"render {case['name']}: boxes max abs "
                                f"{box_abs}, labels {r}")
            cases.append(dict(name=case["name"], hw=(case["h"], case["w"]),
                              labels=len(labels), box_max_abs=box_abs,
                              label=r, image_equal=bool(np.array_equal(
                                  got, ref)),
                              image_ms=image_ms, label_ms=label_ms))
            log(f"  render {case['name']} {case['h']}x{case['w']}, "
                f"{len(labels)} labels: boxes max abs {box_abs}; labels: "
                f"equal share {r['equal']}, max abs {r['max_abs']}, ink IoU "
                f"{r['iou']}, mean abs {r['mean_abs']}; whole picture equal "
                f"{cases[-1]['image_equal']}; save_result {image_ms:.3f} ms "
                f"(draw + PNG write), {label_ms:.4f} ms per label")
        demo = demo_run(trainer_dir, tmp, failures)
    finally:
        shutil.rmtree(tmp)
    route_ms = {way: (float(np.median(v)) if v else None, len(v))
                for way, v in by_route.items()}
    log(f"  the fallback font inflated and parsed in {fallback_ms:.1f} ms; "
        f"the {len(drawn)} glyphs the cases draw rasterised in "
        f"{raster_ms:.1f} ms (each once per process)")
    log("  ms per label by route (the label's costliest glyph: rubik, "
        "fallback, box), median and labels: " + ", ".join(
            f"{way} {ms:.4f} ({n})" if n else f"{way} none"
            for way, (ms, n) in route_ms.items()))
    log("  " + card)
    if failures:
        raise AssertionError("phase 7r: " + "; ".join(failures))
    return dict(cases=cases, demo=demo, raster_ms=raster_ms,
                raster_glyphs=len(drawn), fallback_ms=fallback_ms,
                route_ms=route_ms,
                ms_per_label=float(np.mean([c["label_ms"] for c in cases])),
                ms_per_image={c["name"]: c["image_ms"] for c in cases},
                card=card)


def psnr_db(a, b):
    """RGB PSNR of a against b (8-bit)."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def label_route(label):
    """The route of a label: "box" if any character takes it, else
    "fallback" if any does, else "rubik" (line breaks and what follows
    the end of text aside)."""
    ways = {text.route(ch) for ch in label.split("\0")[0] if ch != "\n"}
    return next(w for w in ("box", "fallback", "rubik") if w in ways)


def demo_run(trainer_dir, tmp, failures):
    """The image demo (`tools.image_demo.main`) at --score-thr 0 on
    RENDER_DEMO_INPUTS with the SSOD checkpoint phase 7 wrote: each render
    under its input's name, in its format (none for .pgm), reading back
    to the pixels it drew (the JPEG, HDR, GIF, JPEG 2000 and AVIF: the
    library's encode of them, cv2's bytes, or an AVIF's headers and
    quantizer, by the CPU tests; HDR reading back within HDR_READBACK
    levels, GIF on its table's steps, JPEG 2000 and AVIF at the render's
    size, an AVIF's PSNR against the render printed); 12 forward MSDA
    launches per image."""
    src = os.path.join(tmp, "in")
    out = os.path.join(tmp, "out")
    os.makedirs(src)
    for name in RENDER_DEMO_INPUTS:
        shutil.copy(os.path.join(native.FIXTURES, name), src)
    drawn = {}
    write_image = image_io.write_image

    def recording_write(path, img):
        drawn[os.path.basename(path)] = np.array(img)
        return write_image(path, img)
    image_io.write_image = recording_write
    try:
        reset_counts()
        t0 = time.perf_counter()
        written = image_demo.main([os.path.join(src, "*"), SSOD_CONFIG,
                                   "--checkpoint", os.path.join(
                                       trainer_dir, "ssod", "ckpt"),
                                   "--output-dir", out, "--score-thr", "0"])
        torch.cuda.synchronize()
        demo_s = time.perf_counter() - t0
    finally:
        image_io.write_image = write_image
    fwd = msda.ms_deform_attn_cuda.launches
    assert_vector(msda.ms_deform_attn_cuda, "demo forward")
    if fwd != 12 * len(RENDER_DEMO_INPUTS) or \
            msda.ms_deform_attn_bwd_cuda.launches:
        failures.append(f"demo: {fwd} forward MSDA launches for "
                        f"{len(RENDER_DEMO_INPUTS)} images")
    if sorted(map(os.path.basename, written)) != sorted(RENDER_DEMO_INPUTS):
        failures.append(f"demo wrote {written}")
    files = {}
    for name in RENDER_DEMO_INPUTS:
        path = os.path.join(out, name)
        ext = name.rsplit(".", 1)[-1]
        if ext in ("pgm", "pbm"):
            if os.path.exists(path):
                failures.append(f"demo wrote {name}; cv2 writes none")
            files[name] = "not written (cv2 refuses a colour .pgm)"
            continue
        if not os.path.isfile(path):
            failures.append(f"demo: no {name}")
            continue
        with open(path, "rb") as f:
            buf = f.read()
        img = drawn[name]
        if not buf.startswith(RENDER_SIGNATURES[ext]):
            failures.append(f"demo: {name} starts {buf[:4]!r}")
        tiles_before = native.avif_tools()["tiles"]
        back = image_io.read_image(path)
        several_tiles = native.avif_tools()["tiles"] > tiles_before
        if ext in RENDER_LOSSY:
            same = buf == RENDER_LOSSY[ext](img) and back.shape == img.shape
            if ext == "hdr":
                same &= int(np.abs(back.astype(int) - img).max()) <= \
                    HDR_READBACK
            if ext == "gif":
                same &= all(set(np.unique(back[..., c]).tolist()) <= steps
                            for c, steps in enumerate(
                                (set(range(0, 253, 36)),) * 2 +
                                ({0, 85, 170, 255},)))
        else:
            same = bool(np.array_equal(back, img))
        if not same:
            failures.append(f"demo: {name} does not read back to its render")
        files[name] = dict(bytes=len(buf), hw=img.shape[:2],
                           reads_back=same)
        if ext == "avif":
            files[name]["psnr_db"] = round(psnr_db(back, img), 4)
            files[name]["several_tiles"] = several_tiles
            if several_tiles != (name == AVIF_TILE_FIXTURES[1]):
                failures.append(f"demo: {name}'s render of "
                                f"{img.shape[1]} wide, several tiles "
                                f"{several_tiles}")
    log(f"  image demo on {len(RENDER_DEMO_INPUTS)} inputs with phase 7's "
        f"checkpoint in {demo_s:.2f} s ({fwd} forward launches): {files}")
    return dict(s=demo_s, launches_fwd=fwd, files=files)


# --------------------------------------------------------------------------
# phase 8: data parallel
# --------------------------------------------------------------------------

def ddp_state(dtype, device):
    """Phase 6's seeded full-width SSOD state in `dtype` on `device`."""
    state, cfg = init_ssod_state(SSOD_CONFIG, device=device, seed=0,
                                 cfg_options={"model.dtype": dtype})
    refine_boxes(state.model, seed=3)
    return state, cfg


def ddp_batch(n_sup, n_unsup, device, nudge=0):
    """This rank's shard of the seeded global batch (W * n_sup + W *
    n_unsup images; the whole of it without a group); `nudge` moves every
    image value by that many float32 roundings, up or down by its sign
    (phase 8a's witnesses)."""
    world = dist.world()
    glob = synthetic_ssod_batch(world * n_sup, world * n_unsup,
                                *SSOD_BUCKET, 100, gt_per_image=12, seed=0,
                                student_flip=True)
    batch = to_device(dist.shard_batch(glob, dist.rank(), world), device)
    for part, key in (("sup", "images"), ("unsup", "student_images"),
                      ("unsup", "teacher_images")):
        x = batch[part][key]
        for _ in range(abs(nudge)):
            x = torch.nextafter(x, torch.full_like(
                x, 1e30 if nudge > 0 else -1e30))
        batch[part][key] = x
    return batch


def state_blob(state):
    """A copy of what a step changes: student, teacher, projector, the
    optimizer's state and the step."""
    return {"student": state.model.state_dict(),
            "teacher": state.teacher.state_dict(),
            "projector": state.projector.state_dict(),
            "optimizer": state.optimizer.adamw.state_dict(),
            "step": state.step}


def recorded_ssod_steps(state, cfg, batch, steps, width, on_step=None,
                        keep_costs=False):
    """The SSOD steps `steps` ((warm_up, score_thr or None)) on `batch`,
    each with its metrics, kept sets, matching costs, the columns of every
    Hungarian solve (with `keep_costs`, its cost matrix and row validity
    too, as numpy, as `hungarian.solve_batch` receives them), MSDA launches
    (all through the `width` instance), host-clock ms around the step and
    a synchronise, and the step's peak device memory (all of it allocated,
    the state included). `on_step(i)` runs after each step."""
    calls, problems = [], []
    solve = hungarian.solve_batch

    def recording_solve(costs, valid):
        cols = solve(costs, valid)
        calls.append(cols.cpu().tolist())
        if keep_costs:
            problems.append((costs.detach().float().cpu().numpy(),
                             valid.cpu().numpy().astype(bool)))
        return cols

    records = []
    hungarian.solve_batch = recording_solve
    try:
        for i, (warm_up, thr) in enumerate(steps):
            step_cfg = cfg if thr is None else dataclasses.replace(
                cfg, score_thr=thr)
            step = make_ssod_train_step(step_cfg, warm_up)
            calls.clear()
            problems.clear()
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            fwd = msda.ms_deform_attn_cuda.launches
            bwd = msda.ms_deform_attn_bwd_cuda.launches
            for wrapper, n in ((msda.ms_deform_attn_cuda, fwd),
                               (msda.ms_deform_attn_bwd_cuda, bwd)):
                if wrapper.launches_by_width.get(width, 0) != n:
                    raise AssertionError(
                        f"rank {dist.rank()} step {i}: launches by width "
                        f"{dict(wrapper.launches_by_width)}, not all {width}")
            if (fwd, bwd) != SSOD_LAUNCHES[warm_up]:
                raise AssertionError(
                    f"rank {dist.rank()} step {i}: {fwd} forward and {bwd} "
                    f"backward MSDA launches, not {SSOD_LAUNCHES[warm_up]}")
            vals = {k: float(v) for k, v in metrics.items()
                    if k not in ("pseudo_vis", "pseudo_sets")}
            bad = [k for k, v in vals.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"rank {dist.rank()} step {i}: "
                                     f"non-finite {bad}")
            assert_state_replicated(state, f"step {i}'s parameters")
            records.append(dict(
                step=i, warm_up=warm_up, ms=ms, fwd=fwd, bwd=bwd, peak=peak,
                metrics=vals, cols=list(calls),
                sets={k: v.cpu().tolist() for k, v in
                      metrics["pseudo_sets"].items()}))
            if keep_costs:
                records[-1]["problems"] = list(problems)
            if on_step is not None:
                on_step(i)
    finally:
        hungarian.solve_batch = solve
    return records


def assert_state_replicated(state, what):
    """Every rank holds what it should of the student, teacher and
    projector, to the bit: the whole of a replicated leaf, and the ranks of
    one shard the same shard."""
    mods = (state.model, state.teacher, state.projector)
    sharding.reshard(*mods)
    leaves = [p for m in mods for p in m.parameters()]
    dist.assert_replicated([sharding.local(p) for p in leaves], what,
                           [sharding.shard_key(p) for p in leaves])


def timed_collective(fn, times):
    """fn, synchronised on both sides so the span holds the collective
    alone; its ms appended to `times`."""
    def timed(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(tensors)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return timed


def measured_align(fn, names, diffs):
    """dist.align_model_group_ that also appends to `diffs` each leaf's
    relative L2 distance between this rank's gradient and the model
    group's first rank's (0 on that rank), by leaf name."""
    def align(tensors):
        mine = [t.clone() for t in tensors]
        fn(tensors)
        out = {}
        for n, a, b in zip(names(), mine, tensors):
            d = (a.double() - b.double()).norm()
            ref = b.double().norm()
            out[n] = float(d / ref) if ref > 0 else (0.0 if d == 0
                                                      else math.inf)
        diffs.append(out)
    return align


def optimizer_grads(state):
    """{name: a copy of its gradient} over the optimizer's parameters."""
    return {n: p.grad.detach().clone() for n, p, _ in state.optimizer.params
            if p.grad is not None}



def ddp_rank(rank, world, init_method, backend, out_dir, legs=(),
             legs_dir=None):
    """One rank of phase 8a: the float32 equality run (rank 0 saves its
    student and projector after each step), then the bfloat16 timing run
    with the gradient all-reduce timed; its records to rank<r>.json. Then
    phase 8c's legs of this world size (`layout_leg_body`, records under
    legs_dir/<leg name>/): the ranks' start and the card's context serve
    both phases."""
    t0 = time.perf_counter()
    parts_s = {}

    def part(name):
        parts_s[name] = round(time.perf_counter() - t0, 2)

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    dist.init_distributed(backend, device, rank, world, init_method)
    done = False
    try:
        part("group")
        # TF32 off, as in the parent since phase 3
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state, cfg = ddp_state("float32", device)
        dist.broadcast_state(state)
        batch = ddp_batch(*DDP_EQ_IMAGES, device)
        part("float32 state")

        def save(i):
            # the state after step i: where one process starts step i + 1
            if dist.is_main():
                torch.save(state_blob(state), os.path.join(
                    out_dir, f"eq_state{i + 1}.pt"))

        save(-1)
        equality = recorded_ssod_steps(state, cfg, batch, DDP_EQ_STEPS, 4,
                                       save)
        del state, batch
        torch.cuda.empty_cache()
        part("float32 steps")

        # TF32 stays off, as in the parent since phase 3 (phase 6's step)
        state, cfg = ddp_state("bfloat16", device)
        dist.broadcast_state(state)
        batch = ddp_batch(SSOD_SUP, SSOD_UNSUP, device)
        grad_bytes = sum(p.numel() * 4 for g in
                         state.optimizer.adamw.param_groups
                         for p in g["params"])
        allreduce_ms = []
        all_sum_ = dist.all_sum_
        part("bfloat16 state")
        # (two synchronisations added to each timed step)
        dist.all_sum_ = timed_collective(all_sum_, allreduce_ms)
        try:
            timing = recorded_ssod_steps(state, cfg, batch, DDP_TIME_STEPS,
                                         MAIN_WIDTH)
        finally:
            dist.all_sum_ = all_sum_
        part("bfloat16 steps")
        for rec, ms in zip(timing, allreduce_ms):
            rec["allreduce_ms"] = ms
            del rec["cols"], rec["sets"]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "device": str(device),
                       "parts_s": parts_s,
                       "backend": dist.backend(), "equality": equality,
                       "timing": timing, "grad_bytes": grad_bytes,
                       "local_state_bytes": sharding.local_state_bytes(
                           state),
                       "peak_memory_bytes": max(t["peak"] for t in timing)},
                      f)
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
        for leg in legs:
            layout_leg_body(leg, device, os.path.join(legs_dir, leg[0]))
        done = True
    finally:
        dist.destroy()
    if done:
        # the work is written and the group left: nothing is left to tear
        # down, so the rank ends at once, without the interpreter's exit
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


def leaf_update_errors(before, after, ref_before, ref_after):
    """{leaf: relative L2 of (after - before) against (ref_after -
    ref_before)} over the leaves the reference moved."""
    out = {}
    for k, r1 in ref_after.items():
        du = ref_after[k].float() - ref_before[k].float()
        if not du.any():
            continue
        d = (after[k].float() - before[k].float()) - du
        out[k] = float(d.norm() / du.norm())
    return out


def single_process_run(state, cfg, nudge, blob_path, step):
    """Phase 8a's reference: one process (no group) on the global batch,
    images moved by `nudge` float32 roundings, takes equality step `step`
    in `state` reset to what rank 0 saved before it, TF32 off as in the
    ranks (cuDNN's default TF32 moved one process's total_loss by ~5 % and
    every discrete choice). Returns its record and its student and
    projector after the step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    blob = torch.load(blob_path, map_location="cuda", weights_only=True)
    state.model.load_state_dict(blob["student"])
    state.teacher.load_state_dict(blob["teacher"])
    state.projector.load_state_dict(blob["projector"])
    state.optimizer.adamw.load_state_dict(blob["optimizer"])
    state.step = blob["step"]
    del blob
    batch = ddp_batch(DDP_WORLD * DDP_EQ_IMAGES[0],
                      DDP_WORLD * DDP_EQ_IMAGES[1], "cuda", nudge=nudge)
    rec, = recorded_ssod_steps(state, cfg, batch, DDP_EQ_STEPS[step:step + 1],
                               4, keep_costs=nudge == 0)
    after = params_of(state)
    del batch
    return rec, after


def params_of(state):
    return {f"{m}.{k}": v.detach().clone() for m, mod in (
        ("student", state.model), ("projector", state.projector))
        for k, v in mod.state_dict().items()}


def ddp_phase(card, bare_ms):
    """Phase 8a; its ranks then run phase 8c's legs of the same world size
    into a directory of their own, which phase 8c checks and removes.
    Returns (the readings, 8c's references, that directory)."""
    backend = "nccl" if torch.cuda.device_count() >= DDP_WORLD else "gloo"
    legs = tuple(leg for leg in LAYOUT_LEGS if leg[3] == DDP_WORLD)
    log(f"== phase 8a: data parallel, two ranks over {backend} "
        f"({'one per card' if backend == 'nccl' else 'on the one card'}): "
        "float32 equality run against one process on the global batch, "
        "bfloat16 timing run at 1 + 4 per rank; then in the same ranks "
        f"phase 8c's legs {[leg[0] for leg in legs]}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    legs_dir = tempfile.mkdtemp(prefix="chip_smoke_layouts_")
    for leg in legs:
        os.makedirs(os.path.join(legs_dir, leg[0]))
    try:
        t0 = time.perf_counter()
        dist.run_local(ddp_rank, DDP_WORLD, (backend, tmp, legs, legs_dir),
                       timeout=DDP_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(DDP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for r in ranks:
            log(f"  rank {r['rank']} on {r['device']} ({r['backend']}), "
                f"bfloat16 1 + 4: step ms "
                f"{[round(t['ms'], 1) for t in r['timing']]}, gradient "
                "all-reduce ms "
                f"{[round(t['allreduce_ms'], 1) for t in r['timing']]} "
                f"({r['grad_bytes']} bytes), MSDA launches per step "
                f"{[(t['fwd'], t['bwd']) for t in r['timing']]}, peak "
                f"memory {r['peak_memory_bytes'] / 2 ** 30:.2f} GiB; "
                f"seconds since its start, by part {r['parts_s']}")
        log(f"  phase 6's one-process step in this call: warm-up "
            f"{bare_ms['warm_up']:.1f} ms, Hungarian "
            f"{bare_ms['hungarian']:.1f} ms"
            + (" (two processes share one card here: no scaling figure)"
               if backend == "gloo" else ""))
        t1 = time.perf_counter()
        checks, failures, refs = [], [], []
        state, cfg = ddp_state("float32", "cuda")
        for i in range(len(DDP_EQ_STEPS)):
            start = os.path.join(tmp, f"eq_state{i}.pt")
            before = params_of_blob(start)
            after = params_of_blob(os.path.join(tmp, f"eq_state{i + 1}.pt"))
            runs = [single_process_run(state, cfg, n, start, i)
                    for n in (0,) + WITNESS_NUDGES]
            c, f = ddp_compare(i, [r["equality"][i] for r in ranks],
                               before, after, runs)
            checks.append(c)
            failures += f
            # phase 8c's references: one process and its witnesses
            refs.append(dict(before=before, runs=runs))
        single_s = time.perf_counter() - t1
        del state
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(legs_dir)
        raise
    finally:
        shutil.rmtree(tmp)
    for c in checks:
        log(f"  equality step {c['step']}: {c}")
    log(f"  ranks {ranks_s:.1f} s (phase 8c's legs in them after "
        f"{max(max(r['parts_s'].values()) for r in ranks):.1f} s), one "
        f"process and its witnesses {single_s:.1f} s")
    log("  " + card)
    if failures:
        shutil.rmtree(legs_dir)
        raise AssertionError("phase 8a: " + "; ".join(failures))
    launches = {kind: [sum(t[kind] for run in ("equality", "timing")
                           for t in r[run]) for r in ranks]
                for kind in ("fwd", "bwd")}
    return dict(backend=backend, ranks=[{k: v for k, v in r.items()
                                         if k != "equality"} for r in ranks],
                equality=checks, launches=launches, bare_step_ms=bare_ms,
                ranks_s=ranks_s, card=card), refs, legs_dir


def params_of_blob(path):
    blob = torch.load(path, map_location="cuda", weights_only=True)
    return {f"{m}.{k}": v for m in ("student", "projector")
            for k, v in blob[m].items()}


def ddp_compare(i, recs, before, after, runs, scale=None):
    """Phase 8a's checks of equality step i, all runs from one state: the
    ranks' records `recs` and parameters `after` against one process on
    the global batch and its witnesses (`runs`: one process, then the
    same with the images moved by WITNESS_NUDGES float32 roundings). The
    ranks agree with each other exactly; their kept sets and GMM element
    equal one process's, and each Hungarian solve's columns too or a near
    tie (`tools.hungarian_hold.hold_solve`, one process's record holding
    the solves' cost matrices); each loss term, the total,
    grad_norm and gmm_thr, and the per-leaf update errors (worst and
    median) lie within WITNESS_FACTOR times the witnesses' largest distance
    from one process, plus DDP_FLOOR of the total loss (a term) or of the
    value. `scale` (phase 8c): (before, runs) of another start whose
    witnesses give the limits, where `runs` holds one process alone.
    Returns (the readings, the failures)."""
    ref, ref_after = runs[0]
    s_before, s_runs = scale if scale is not None else (before, runs)
    (s_ref, s_ref_after), s_wits = s_runs[0], s_runs[1:]
    failures = []

    def fail(msg):
        failures.append(f"equality step {i}: {msg}")

    if any(r["metrics"] != recs[0]["metrics"] for r in recs):
        fail("rank metrics differ")
    readings = dict(step=i, warm_up=ref["warm_up"])
    for key in ("valid", "keep_sup", "keep_cons"):
        same = [row for r in recs for row in r["sets"][key]] == \
            ref["sets"][key]
        readings[key] = same
        if not same:
            fail(f"{key} differs from one process's")
    # the GMM threshold is one cost of the pool: the same pseudo box
    valid = np.asarray(ref["sets"]["valid"]).reshape(-1)

    def picked(costs, thr):
        return [int(k) for k in np.flatnonzero(valid & (np.asarray(
            costs, np.float32).reshape(-1) == np.float32(thr)))]
    got = picked([row for r in recs for row in r["sets"]["costs"]],
                 recs[0]["metrics"]["gmm_thr"])
    ones = [picked(w["sets"]["costs"], w["metrics"]["gmm_thr"])
            for w, _ in runs + list(s_wits if scale is not None else [])]
    readings["gmm_element"] = (got, ones)
    if got != ones[0] or len(got) != 1:
        fail(f"GMM element {got}, one process {ones[0]}")
    # Hungarian columns: rank r's rows of each solve (batch axis -2), equal
    # to one process's, or a near tie held by its matching cost
    # (`tools.hungarian_hold`: a witness flips it too, and the ranks'
    # assignment costs at most WITNESS_FACTOR times a witness's excess more
    # than one process's optimum)
    hung = []
    if any(len(r["cols"]) != len(ref["cols"]) for r in recs):
        fail(f"Hungarian solves {[len(r['cols']) for r in recs]} per rank, "
             f"one process {len(ref['cols'])}")
    else:
        for k, cols in enumerate(ref["cols"]):
            full = np.asarray(cols)
            parts = np.concatenate([np.asarray(r["cols"][k]) for r in recs],
                                   axis=full.ndim - 2)
            costs, valid = ref["problems"][k]
            w_costs, w_valid = s_ref["problems"][k]
            h = hungarian_hold.hold_solve(
                parts, costs, valid, full, w_costs, w_valid,
                s_ref["cols"][k], [w["cols"][k] for w, _ in s_wits],
                WITNESS_FACTOR)
            hung.append(h["verdict"] if h["verdict"] == "equal" else (
                h["verdict"], h["excess"], h["witness_excess"],
                h["witnesses_flipped"]))
            if h["verdict"] == "failed":
                fail(f"Hungarian solve {k}: {h['why']}")
    readings["hungarian"] = hung
    m, rm = recs[0]["metrics"], ref["metrics"]
    total = abs(rm["total_loss"])
    terms = {}
    for k in [k for k in rm if "loss" in k] + ["grad_norm", "gmm_thr"]:
        got_d = abs(m[k] - rm[k])
        wit_d = max(abs(w["metrics"][k] - s_ref["metrics"][k])
                    for w, _ in s_wits)
        floor = DDP_FLOOR * (total if "loss" in k and k != "total_loss"
                             else abs(rm[k]))
        terms[k] = (got_d, wit_d)
        if got_d > WITNESS_FACTOR * wit_d + floor:
            fail(f"{k} {m[k]} vs one process {rm[k]} (witnesses "
                 f"{[w['metrics'][k] for w, _ in s_wits]})")
    upd = leaf_update_errors(before, after, before, ref_after)
    wupd = [leaf_update_errors(s_before, a, s_before, s_ref_after)
            for _, a in s_wits]
    worst, med = max(upd.values()), float(np.median(list(upd.values())))
    wworst = max(max(u.values()) for u in wupd)
    wmed = max(float(np.median(list(u.values()))) for u in wupd)
    if worst > WITNESS_FACTOR * wworst + DDP_FLOOR or \
            med > WITNESS_FACTOR * wmed + DDP_FLOOR:
        fail(f"update errors worst {worst} median {med}, witnesses "
             f"{wworst} / {wmed}")
    readings.update(
        {k: (m[k], rm[k], [w["metrics"][k] for w, _ in s_wits])
         for k in ("total_loss", "grad_norm", "gmm_thr")},
        worst_loss_term=max(((k, v) for k, v in terms.items()
                             if "loss" in k and k != "total_loss"),
                            key=lambda kv: kv[1][0]),
        update_worst=(worst, wworst), update_median=(med, wmed),
        sup_set_per_img=recs[0]["metrics"]["sup_set_per_img"],
        ms=([r["ms"] for r in recs], ref["ms"]))
    return readings, failures


def torchrun_cli_rank(out, argv):
    """Phase 8b's rank, started by torch.distributed.run: the SSOD CLI's
    `main` on `argv`, with the MSDA launches of each step and each eval
    counted in this process; rank 0 writes them to `out` as JSON."""
    per_step, evals = [], []
    run_step, evaluate = SsodTrainer._run_step, SsodTrainer.evaluate

    def counted_step(self, step, batch, vis_img):
        reset_counts()
        result = run_step(self, step, batch, vis_img)
        per_step.append((step, msda.ms_deform_attn_cuda.launches,
                         msda.ms_deform_attn_bwd_cuda.launches))
        assert_vector(msda.ms_deform_attn_cuda, f"step {step} forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda, f"step {step} backward")
        return result

    def counted_eval(self, step, warm_up):
        reset_counts()
        result = evaluate(self, step, warm_up)
        evals.append((step, msda.ms_deform_attn_cuda.launches,
                      len(self.val_dataset)))
        return result

    SsodTrainer._run_step, SsodTrainer.evaluate = counted_step, counted_eval
    try:
        trainer = train_detr_ssod.main(argv)
        record = dict(backend=dist.backend(), world=dist.world(),
                      rank=dist.rank(), device=str(trainer.device),
                      per_step=per_step, evals=evals,
                      steps=[t["step"] for t in trainer.timings],
                      ckpts=trainer.ckpt.all_steps())
        if dist.is_main():
            with open(out, "w") as f:
                json.dump(record, f)
    finally:
        SsodTrainer._run_step, SsodTrainer.evaluate = run_step, evaluate
        dist.destroy()
    # as phase 8a's ranks: written and out of the group, it ends at once
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def torchrun_phase(card, trainer_per_step):
    log("== phase 8b: the SSOD CLI under torch.distributed.run (NCCL, world "
        f"1): {TORCHRUN_STEPS} steps, eval, a checkpoint")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_torchrun_")
    try:
        n_img = max(max(r) for r in TRAINER_SPLITS.values()) + 1
        paths, img_dir = write_synthetic_coco(tmp, n=n_img, seed=0,
                                              splits=TRAINER_SPLITS,
                                              **TRAINER_SET)
        work, out = os.path.join(tmp, "ssod"), os.path.join(tmp, "rank.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", os.path.abspath(__file__),
               TORCHRUN_FLAG, out, SSOD_CONFIG, "--work-dir", work,
               "--max-steps", str(TORCHRUN_STEPS), "--cfg-options",
               f"data.train_sup_ann={paths['sup']}",
               f"data.train_unsup_ann={paths['unsup']}",
               f"data.val_ann={paths['val']}",
               f"data.train_prefix={img_dir}", f"data.val_prefix={img_dir}",
               f"ssod.warm_up_step={TORCHRUN_WARM_UP}",
               f"eval_interval={TORCHRUN_WARM_UP}",
               f"ckpt_interval={TORCHRUN_STEPS}",
               f"image_log_interval={TORCHRUN_WARM_UP}"]
        t0 = time.perf_counter()
        # a session of its own, so a timeout kills the launcher's worker too
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)), start_new_session=True)
        try:
            output = proc.communicate(timeout=TORCHRUN_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise AssertionError(f"torch.distributed.run did not end within "
                                 f"{TORCHRUN_TIMEOUT} s")
        run_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torch.distributed.run exited "
                                 f"{proc.returncode}:\n{output[-4000:]}")
        with open(out) as f:
            rec = json.load(f)
        with open(os.path.join(work, "train.log")) as f:
            train_log = f.read()
        if "data parallel: backend nccl, world 1, rank 0" not in train_log:
            raise AssertionError("the run's log does not name backend nccl")
        if (rec["backend"], rec["world"]) != ("nccl", 1):
            raise AssertionError(f"process group {rec}")
        if rec["steps"] != list(range(TORCHRUN_STEPS)):
            raise AssertionError(f"steps run: {rec['steps']}")
        if not os.path.isfile(os.path.join(work, "ckpt",
                                           f"step_{TORCHRUN_STEPS}.pt")):
            raise AssertionError(f"no checkpoint by rank 0: {rec['ckpts']}")
        # per step as phase 7's steps of the same stage
        phase7 = {step < TRAINER_WARM_UP: (f, b)
                  for step, f, b in trainer_per_step}
        for step, f, b in rec["per_step"]:
            warm_up = step < TORCHRUN_WARM_UP
            if (f, b) != SSOD_LAUNCHES[warm_up] or (f, b) != phase7[warm_up]:
                raise AssertionError(f"torchrun step {step}: {f} forward and "
                                     f"{b} backward MSDA launches, phase 7 "
                                     f"{phase7[warm_up]}")
        n_batches = -(-len(TRAINER_SPLITS["val"]) // EVAL_BATCH)
        if [e[1] for e in rec["evals"]] != [2 * n_batches * 12]:
            raise AssertionError(f"torchrun evals {rec['evals']}")
        evals_logged = read_evals(os.path.join(work, "train.log"))
        for tag in ("teacher", "student"):
            check_aps(evals_logged[(tag, TORCHRUN_WARM_UP)],
                      f"torchrun Eval[{tag}]")
    finally:
        shutil.rmtree(tmp)
    log(f"  torch.distributed.run: {run_s:.1f} s (process start included); "
        f"backend {rec['backend']} on {rec['device']}; MSDA launches per "
        f"step {[(f, b) for _, f, b in rec['per_step']]}, per eval "
        f"{[e[1] for e in rec['evals']]}; checkpoint {rec['ckpts']}")
    log("  " + card)
    return dict(rec, run_s=run_s, card=card)

# --------------------------------------------------------------------------
# phase 8c: FSDP, tensor parallelism, donation
# --------------------------------------------------------------------------

def ffn_params(state):
    """(local, whole) parameter counts of the student's FFN leaves (the 12
    linear1 / linear2 pairs)."""
    loc = whole = 0
    for n, p in state.model.named_parameters():
        if n.split(".")[-2] in ("linear1", "linear2"):
            loc += sharding.local(p).numel()
            whole += p.numel()
    return loc, whole


def frozen_sums(state):
    return [int(dist.bit_checksum(sharding.local(p)))
            for n, p in state.model.named_parameters()
            if n.startswith(("backbone.conv1.", "backbone.bn1.",
                             "backbone.layer1."))]


def layout_rank(rank, world, init_method, backend, legs, out_dir,
                cli=None):
    """One rank of a phase 8c spawn: each leg of `legs` (of this world size)
    in turn, its records under out_dir/<leg name>/, then, with cli = (argv,
    out), the SSOD CLI (`layout_cli`). One spawn per world size: the legs
    share the processes' start, the group and the card's context."""
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    dist.init_distributed(backend, device, rank, world, init_method)
    done = False
    try:
        for leg in legs:
            layout_leg_body(leg, device, os.path.join(out_dir, leg[0]))
        if cli is not None:
            layout_cli(device, *cli)
        done = True
    finally:
        dist.destroy()
    if done:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


def layout_leg_body(leg, device, out_dir):
    """One rank's part of a phase 8c leg ((name, fsdp, tp, world)): the
    float32 equality run on the leg's layout (rank 0 saves the full state
    before each step; under TP each rank's gradients before the model
    group's broadcast measured against the group's first rank's), then the
    bfloat16 timing run with its local state bytes and its all-reduce and
    broadcast timed; its records to rank<r>.json. TF32 is restored after
    it."""
    name, fsdp, tp, _ = leg
    t0 = time.perf_counter()
    parts_s = {}

    def part(what):
        parts_s[what] = round(time.perf_counter() - t0, 2)

    all_sum_, align_ = dist.all_sum_, dist.align_model_group_
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        mesh = dist.make_mesh(tp, device)
        part("mesh")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state, cfg = ddp_state("float32", device)
        dist.broadcast_state(state)
        sharding.shard_state(state, mesh, fsdp, tp)
        # phase 8a's global batch, over this leg's data ranks
        batch = ddp_batch(*(DDP_WORLD * n // dist.world()
                            for n in DDP_EQ_IMAGES), device)
        frozen0 = frozen_sums(state)
        teacher0 = [int(dist.bit_checksum(sharding.local(p)))
                    for p in state.teacher.parameters()]
        part("float32 state")

        def save(i):
            blob = ckpt_mod.full_blob(state, state.step)
            if dist.is_main():
                torch.save(blob, os.path.join(out_dir,
                                              f"eq_state{i + 1}.pt"))

        def aligned_names():
            # the leaves the optimizer hands to the broadcast, in its order
            return [n for n, p, _ in state.optimizer.params
                    if "model" not in sharding.sharded_axes(p)]

        align_diffs = []
        if tp > 1:
            dist.align_model_group_ = measured_align(align_, aligned_names,
                                                     align_diffs)
        save(-1)
        equality = recorded_ssod_steps(state, cfg, batch,
                                       layout_eq_steps(tp), 4, save)
        dist.align_model_group_ = align_
        checks = dict(
            frozen_unchanged=frozen_sums(state) == frozen0,
            teacher_moved=sum(int(dist.bit_checksum(sharding.local(p))) != c
                              for p, c in zip(state.teacher.parameters(),
                                              teacher0)))
        # FSDP's and TP's hooks tie a laid-out module into reference
        # cycles: without a collection its float32 shards outlive it into
        # the bfloat16 run (328 MiB held through an FSDP rank's steps;
        # NVIDIA H100 80GB HBM3, 700.00 W)
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
        part("float32 steps")

        state, cfg = ddp_state("bfloat16", device)
        dist.broadcast_state(state)
        sharding.shard_state(state, mesh, fsdp, tp)
        batch = ddp_batch(SSOD_SUP, SSOD_UNSUP, device)
        part("bfloat16 state")
        allreduce_ms, broadcast_ms = [], []
        dist.all_sum_ = timed_collective(all_sum_, allreduce_ms)
        dist.align_model_group_ = timed_collective(align_, broadcast_ms)
        timing = recorded_ssod_steps(state, cfg, batch, LAYOUT_TIME_STEPS,
                                     MAIN_WIDTH)
        dist.all_sum_, dist.align_model_group_ = all_sum_, align_
        for rec, ar, bc in zip(timing, allreduce_ms, broadcast_ms):
            rec.update(allreduce_ms=ar, broadcast_ms=bc)
            del rec["cols"], rec["sets"]
        part("bfloat16 steps")
        with open(os.path.join(out_dir, f"rank{dist.world_rank()}.json"),
                  "w") as f:
            json.dump({"rank": dist.world_rank(), "device": str(device),
                       "backend": dist.backend(), "data_rank": dist.rank(),
                       "data_world": dist.world(), "parts_s": parts_s,
                       "equality": equality, "timing": timing,
                       "align_diffs": align_diffs, "checks": checks,
                       "local_state_bytes": sharding.local_state_bytes(
                           state),
                       "ffn_params": ffn_params(state),
                       "peak_memory_bytes": max(t["peak"] for t in timing)},
                      f)
    finally:
        dist.all_sum_, dist.align_model_group_ = all_sum_, align_
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    # the laid-out state is freed before the next leg (FSDP's and TP's
    # hooks tie it into reference cycles)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    dist.drop_mesh()


class tp_order:
    """One process computing the FFN pairs in the TP ranks' order, for the
    TP legs' references: each linear1 as `tp` column blocks, each linear2
    as `tp` row blocks each adding bias / tp (the rank's part of the
    DTensor bias), summed in rank order, as RowwiseParallel's all-reduce
    sums them. Without it one process rounds every FFN output of 12 layers
    differently, and at full width with random weights one such rounding
    flips the discrete choices (8a's witnesses)."""

    def __init__(self, tp, *models):
        self.tp, self.models = tp, models

    def layers(self):
        for m in self.models:
            t = m.bbox_head.transformer
            yield from list(t.encoder.layers) + list(t.decoder.layers)

    def __enter__(self):
        tp = self.tp
        for layer in self.layers():
            l1, l2 = layer.linear1, layer.linear2

            def fwd1(x, m=l1):
                dt = m._dtype(m.weight)
                x = x.to(dt)
                return torch.cat([
                    torch.nn.functional.linear(x, w.to(dt), b.to(dt))
                    for w, b in zip(m.weight.chunk(tp, 0),
                                    m.bias.chunk(tp, 0))], -1)

            def fwd2(h, m=l2):
                dt = m._dtype(m.weight)
                h, b = h.to(dt), m.bias.to(dt) / tp
                out = None
                for hh, w in zip(h.chunk(tp, -1), m.weight.chunk(tp, 1)):
                    y = torch.nn.functional.linear(hh, w.to(dt), b)
                    out = y if out is None else out + y
                return out

            l1.forward, l2.forward = fwd1, fwd2
        return self

    def __exit__(self, *exc):
        for layer in self.layers():
            del layer.linear1.forward, layer.linear2.forward


def check_align(diffs, floor):
    """The TP ranks' gradients before the model group's broadcast (`diffs`,
    per leaf the largest over the ranks) against the atomic-order floor
    (`floor`: per leaf, one process against itself from the same state):
    the worst leaf within ALIGN_FACTOR times the worst floor, the median
    within ALIGN_FACTOR times the floor's median plus DDP_FLOOR. Leaves
    at zero on both sides are left out. Returns (the readings, the
    failures)."""
    keys = [k for k in diffs if diffs[k] > 0 or floor.get(k, 0.0) > 0]
    if not keys:
        return dict(leaves=0), []
    fl = {k: floor.get(k, 0.0) for k in keys}
    worst = max(keys, key=diffs.get)
    out = dict(leaves=len(keys), worst_leaf=worst, worst=diffs[worst],
               floor_of_worst=fl[worst], worst_floor=max(fl.values()),
               median=float(np.median([diffs[k] for k in keys])),
               floor_median=float(np.median(list(fl.values()))),
               above_a_zero_floor=sum(1 for k in keys
                                      if fl[k] == 0 and diffs[k] > 0))
    failures = []
    if (out["worst"] > ALIGN_FACTOR * out["worst_floor"]
            or out["median"] > ALIGN_FACTOR * out["floor_median"]
            + DDP_FLOOR):
        failures.append(f"the TP ranks' gradients before the broadcast "
                        f"differ beyond the atomic-order floor: {out}")
    return out, failures


def layout_backend(world):
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def check_leg(leg, tmp, refs, dp_bytes, state, cfg):
    """A phase 8c leg's checks, once its ranks have written their records
    to tmp: against phase 8a's references (step 0: one process and its
    witnesses from the same seeded start; step 1: one process from the
    leg's own state, limits from 8a's witnesses). Under TP, one process
    takes step 0 twice: the second run's gradients against the first's are
    the floor of the ranks' differences before the broadcast. Returns (the
    readings, the failures)."""
    name, fsdp, tp, world = leg
    backend = layout_backend(world)
    failures, align = [], None
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    # one record per data rank, in data order (TP ranks alike)
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["data_rank"], r)
    data_recs = [by_data[d] for d in sorted(by_data)]
    checks = []
    for i in range(len(layout_eq_steps(tp))):
        if any(r["equality"][i]["metrics"] != ranks[0]["equality"][i][
                "metrics"] for r in ranks):
            failures.append(f"{name} step {i}: the ranks' metrics differ")
        start = os.path.join(tmp, f"eq_state{i}.pt")
        after = params_of_blob(os.path.join(tmp, f"eq_state{i + 1}.pt"))
        before = params_of_blob(start)
        recs = [r["equality"][i] for r in data_recs]
        if i == 0 and any(not torch.equal(before[k], refs[0]["before"][
                k]) for k in before):
            failures.append(f"{name}: its start is not phase 8a's")
        if i == 0 and tp == 1:
            runs, scale = refs[0]["runs"], None
        else:
            # one process from the leg's own state (in the TP ranks'
            # order of the FFN sums), limits from 8a's witnesses
            with tp_order(tp, state.model, state.teacher) if tp > 1 \
                    else contextlib.nullcontext():
                runs = [single_process_run(state, cfg, 0, start, i)]
                if i == 0:
                    first = optimizer_grads(state)
                    single_process_run(state, cfg, 0, start, i)
                    floor = rel_errors([({"g": first}, {
                        "g": optimizer_grads(state)})], "g")
                    del first
                    diffs = {}
                    for r in ranks:
                        for k, v in r["align_diffs"][0].items():
                            diffs[k] = max(diffs.get(k, 0.0), v)
                    align, f = check_align(diffs, floor)
                    failures += [f"{name}: {x}" for x in f]
            scale = (refs[i]["before"], refs[i]["runs"])
        c, f = ddp_compare(i, recs, before, after, runs, scale)
        if i == 0 and tp > 1:
            # beside plain one process (8a's), reported, not held: the
            # TP order is a rounding of every FFN output
            c["plain_one_process"] = ddp_compare(
                i, recs, before, after, refs[0]["runs"])[0]
        checks.append(c)
        failures += [f"{name}: {x}" for x in f]
        del before, after
    for r in ranks:
        if not r["checks"]["frozen_unchanged"]:
            failures.append(f"{name} rank {r['rank']}: frozen leaves "
                            "changed")
        if not r["checks"]["teacher_moved"]:
            failures.append(f"{name} rank {r['rank']}: the teacher did "
                            "not move")
        share = r["local_state_bytes"] / dp_bytes
        r["state_share"] = share
        if fsdp and share > LAYOUT_STATE_SHARE:
            failures.append(f"{name} rank {r['rank']}: local state "
                            f"{share:.3f} of the data-parallel rank's")
        loc, whole = r["ffn_params"]
        if tp > 1 and loc > whole / tp + TP_REPLICATED_FFN:
            failures.append(f"{name} rank {r['rank']}: FFN {loc} of "
                            f"{whole} parameters")
        log(f"  {name} rank {r['rank']} (data rank {r['data_rank']} of "
            f"{r['data_world']}, {r['backend']}): bfloat16 1 + 4 step ms "
            f"{[round(t['ms'], 1) for t in r['timing']]} (all-reduce "
            f"{[round(t['allreduce_ms'], 1) for t in r['timing']]}, "
            f"model-group broadcast "
            f"{[round(t['broadcast_ms'], 1) for t in r['timing']]}), "
            f"peak memory by step "
            f"{[round(t['peak'] / 2 ** 30, 3) for t in r['timing']]} "
            f"GiB, MSDA launches per step "
            f"{[(t['fwd'], t['bwd']) for t in r['timing']]}, local state "
            f"{r['local_state_bytes']} bytes ({share:.3f} of data "
            f"parallel's {dp_bytes}), FFN {loc} of {whole} parameters; "
            f"seconds by part {r['parts_s']}")
    for c in checks:
        log(f"  {name} equality step {c['step']}: {c}")
    if align is not None:
        log(f"  {name}: gradients before the model group's broadcast "
            f"against one process's atomic-order floor: {align}")
    body_s = max(max(r["parts_s"].values()) for r in ranks)
    log(f"  {name}: the leg's part of its ranks {body_s:.1f} s")
    launches = {kind: [sum(t[kind] for run in ("equality", "timing")
                           for t in r[run]) for r in ranks]
                for kind in ("fwd", "bwd")}
    return dict(backend=backend, world=world, fsdp=fsdp, tp=tp,
                ranks=[{k: v for k, v in r.items()
                        if k not in ("equality", "align_diffs")}
                       for r in ranks], equality=checks, align=align,
                launches=launches, body_s=body_s), failures


def donation_check():
    """Every step is donated (`train.optim`): the EMA's products and
    AdamW's denominators are made optim.UPDATE_CHUNK elements at a time.
    One SSOD step's EMA and optimizer update so, against the same update
    over the whole state in one call each, from one state and one set of
    gradients (full width, bfloat16, seeded weights, the gradients seeded
    too), DONATION_ROUNDS times in turns: the results bit-equal, every
    state tensor in its storage, the update's peak memory above the state
    no higher in chunks, and each mode's ms (median); then a whole step
    keeps the storage."""
    state, cfg = ddp_state("bfloat16", "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    trainable = [p for _, p, _ in state.optimizer.params]
    for p in trainable:
        p.grad = 1e-3 * torch.randn(p.shape, device="cuda", generator=g)
    # Adam's moments exist after one update
    state.optimizer.step(0)
    snap = [t.detach().clone() for t in donation_tensors(state)]
    grads = [p.grad.clone() for p in trainable]
    chunk = optim.UPDATE_CHUNK
    modes = {"whole": 1 << 62, "chunked": chunk}
    res = {m: dict(out=None, peaks=[], ms=[], ptrs=[]) for m in modes}
    try:
        for _ in range(DONATION_ROUNDS):
            for mode, size in modes.items():
                optim.UPDATE_CHUNK = size
                with torch.no_grad():
                    for t, v in zip(donation_tensors(state), snap):
                        t.copy_(v)
                    for p, v in zip(trainable, grads):
                        p.grad.copy_(v)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                ema_update(state.teacher, state.model, 7, cfg.ema_momentum)
                state.optimizer.step(1)
                torch.cuda.synchronize()
                r = res[mode]
                r["ms"].append((time.perf_counter() - t0) * 1e3)
                r["peaks"].append(torch.cuda.max_memory_allocated() - base)
                tensors = donation_tensors(state)
                r["ptrs"].append([t.data_ptr() for t in tensors])
                if r["out"] is None:
                    r["out"] = [t.detach().clone() for t in tensors]
    finally:
        optim.UPDATE_CHUNK = chunk
    equal = all(torch.equal(a, b) for a, b in zip(res["whole"]["out"],
                                                  res["chunked"]["out"]))
    ptrs = [p for r in res.values() for p in r["ptrs"]]
    del snap, grads
    for r in res.values():
        del r["out"]
    # a whole step: every state tensor keeps its storage
    batch = ddp_batch(SSOD_SUP, SSOD_UNSUP, "cuda")
    before = [t.data_ptr() for t in donation_tensors(state)]
    torch.cuda.reset_peak_memory_stats()
    make_ssod_train_step(cfg, warm_up=True)(state, batch)
    torch.cuda.synchronize()
    kept = before == [t.data_ptr() for t in donation_tensors(state)]
    step_peak = torch.cuda.max_memory_allocated()
    del state, batch
    torch.cuda.empty_cache()
    return dict(bit_equal=equal,
                storage_kept=all(p == ptrs[0] for p in ptrs) and kept,
                update_peak_bytes={m: max(r["peaks"]) for m, r in res.items()},
                update_ms={m: float(np.median(r["ms"]))
                           for m, r in res.items()},
                update_ms_runs={m: r["ms"] for m, r in res.items()},
                chunk_elements=chunk, step_peak_bytes=step_peak)


def donation_tensors(state):
    """Every tensor of the state a step updates: the parameters, the
    teacher's, the Adam moments and their step counts."""
    out = [sharding.local(p) for m in (state.model, state.teacher,
                                       state.projector)
           for p in m.parameters()]
    for st in state.optimizer.adamw.state.values():
        out += [v for _, v in sorted(st.items())
                if isinstance(v, torch.Tensor)]
    return out


def layout_cli(device, argv, out):
    """Phase 8c's trainer, in a rank of the 4-rank spawn after its leg: the
    SSOD CLI's `main` on `argv` in the joined group (its `load_cfg` finds
    it), MSDA launches counted per step; rank 0 writes its record to
    `out`."""
    per_step = []
    run_step = SsodTrainer._run_step

    def counted_step(self, step, batch, vis_img):
        reset_counts()
        result = run_step(self, step, batch, vis_img)
        per_step.append((step, msda.ms_deform_attn_cuda.launches,
                         msda.ms_deform_attn_bwd_cuda.launches))
        return result

    SsodTrainer._run_step = counted_step
    t0 = time.perf_counter()
    try:
        trainer = train_detr_ssod.main(argv + ["--device", str(device)])
        if dist.is_main():
            with open(out, "w") as f:
                json.dump(dict(per_step=per_step, steps=[
                    t["step"] for t in trainer.timings],
                    ckpts=trainer.ckpt.all_steps(),
                    local_state_bytes=sharding.local_state_bytes(
                        trainer.state), run_s=time.perf_counter() - t0), f)
    finally:
        SsodTrainer._run_step = run_step


def layout_cli_args(tmp):
    """The SSOD CLI's arguments for phase 8c's trainer (fsdp=True tp=2
    donate=True over LAYOUT_CLI_WORLD ranks) on a synthetic JPEG set
    written under tmp: LAYOUT_CLI_STEPS steps, an eval, a checkpoint.
    Returns (argv without --max-steps, work dir, the record's path)."""
    n_img = max(max(r) for r in TRAINER_SPLITS.values()) + 1
    paths, img_dir = write_synthetic_coco(tmp, n=n_img, seed=0,
                                          splits=TRAINER_SPLITS,
                                          **TRAINER_SET)
    work, out = os.path.join(tmp, "ssod"), os.path.join(tmp, "cli.json")
    argv = [SSOD_CONFIG, "--work-dir", work, "--cfg-options",
            f"data.train_sup_ann={paths['sup']}",
            f"data.train_unsup_ann={paths['unsup']}",
            f"data.val_ann={paths['val']}",
            f"data.train_prefix={img_dir}", f"data.val_prefix={img_dir}",
            f"ssod.warm_up_step={LAYOUT_CLI_STEPS // 2}",
            # an eval after the last step (index LAYOUT_CLI_STEPS - 1)
            f"eval_interval={LAYOUT_CLI_STEPS - 1}",
            f"ckpt_interval={LAYOUT_CLI_STEPS}", "image_log_interval=0",
            "log_interval=1", "fsdp=True", "tp=2", "donate=True"]
    return argv, work, out


def check_trainer(argv, work, out):
    """Phase 8c's trainer, once its ranks have run (rank 0's record at
    out): LAYOUT_CLI_STEPS steps with exact launches, the layout in the
    log, the evals, the checkpoint; then that checkpoint resumed in one
    process for one step. Returns (the readings, the failures)."""
    world = LAYOUT_CLI_WORLD
    backend = layout_backend(world)
    failures = []
    with open(out) as f:
        rec = json.load(f)
    with open(os.path.join(work, "train.log")) as f:
        train_log = f.read()
    if rec["steps"] != list(range(LAYOUT_CLI_STEPS)):
        failures.append(f"trainer steps {rec['steps']}")
    if LAYOUT_CLI_STEPS not in rec["ckpts"]:
        failures.append(f"no checkpoint: {rec['ckpts']}")
    for step, f, b in rec["per_step"]:
        if (f, b) != SSOD_LAUNCHES[step < LAYOUT_CLI_STEPS // 2]:
            failures.append(f"trainer step {step}: {f} + {b} launches")
    want = f"layout: mesh (data {world // 2}, model 2), fsdp=True, tp=2"
    if want not in train_log:
        failures.append("the log does not name the layout")
    for tag in ("teacher", "student"):
        if f"Eval[{tag}] iter {LAYOUT_CLI_STEPS - 1}: mAP=" \
                not in train_log:
            failures.append(f"no Eval[{tag}] line")
    aps = {f"{tag} iter {step}": res for (tag, step), res in
           read_evals(os.path.join(work, "train.log")).items()}
    for what, res in aps.items():
        check_aps(res, f"layout trainer Eval[{what}]")
    # the checkpoint (full tensors) resumed in one process, one step
    t1 = time.perf_counter()
    resumed = train_detr_ssod.main(
        argv[:1] + ["--max-steps", str(LAYOUT_CLI_STEPS + 1)]
        + argv[1:-3] + ["eval_interval=1000"])
    resume_s = time.perf_counter() - t1
    with open(os.path.join(work, "train.log")) as f:
        if f.read().count(f"resumed from step {LAYOUT_CLI_STEPS}") != 1:
            failures.append("one process did not resume the checkpoint")
    if [t["step"] for t in resumed.timings] != [LAYOUT_CLI_STEPS]:
        failures.append(f"resumed steps {resumed.timings}")
    del resumed
    torch.cuda.empty_cache()
    log(f"  trainer, fsdp=True tp=2 donate=True over {world} ranks "
        f"({backend}): steps {rec['steps']}, launches per step "
        f"{rec['per_step']}, rank 0's local state "
        f"{rec['local_state_bytes']} bytes, {rec['run_s']:.1f} s in its "
        f"ranks; resumed in one process for one step in {resume_s:.1f} s")
    return dict(backend=backend, world=world, per_step=rec["per_step"],
                run_s=rec["run_s"], resume_s=resume_s, evals=aps,
                local_state_bytes=rec["local_state_bytes"]), failures


def layout_phase(card, refs, ddp, tmp):
    log("== phase 8c: FSDP, TP and FSDP + TP (float32 equality against one "
        "process, bfloat16 timing at 1 + 4 per data rank), donation, the "
        "SSOD CLI with fsdp=True tp=2 over 4 ranks")
    dp_bytes = ddp["ranks"][0]["local_state_bytes"]
    state, cfg = ddp_state("float32", "cuda")
    legs, failures, spawns = {}, [], {}
    try:
        argv, work, out = layout_cli_args(os.path.join(tmp, "cli"))
        # one spawn per world size, its legs in turn in the same ranks:
        # those of phase 8a's world ran in 8a's ranks (their records are in
        # tmp already); in the LAYOUT_CLI_WORLD ranks the trainer follows
        for world in sorted({leg[3] for leg in LAYOUT_LEGS}):
            group = tuple(leg for leg in LAYOUT_LEGS if leg[3] == world)
            if world == DDP_WORLD:
                log(f"  legs {[leg[0] for leg in group]}: run in phase 8a's"
                    f" ranks")
            else:
                cli = (argv[:1] + ["--max-steps", str(LAYOUT_CLI_STEPS)]
                       + argv[1:], out) if world == LAYOUT_CLI_WORLD \
                    else None
                for leg in group:
                    os.makedirs(os.path.join(tmp, leg[0]))
                t0 = time.perf_counter()
                dist.run_local(layout_rank, world, (
                    layout_backend(world), group, tmp, cli),
                    timeout=LAYOUT_TIMEOUT)
                spawns[world] = dict(legs=[leg[0] for leg in group],
                                     trainer=cli is not None,
                                     s=time.perf_counter() - t0)
                log(f"  {world} ranks ({layout_backend(world)}): legs "
                    f"{spawns[world]['legs']}"
                    + (" and the trainer" if cli is not None else "")
                    + f" in {spawns[world]['s']:.1f} s")
            for leg in group:
                rec, f = check_leg(leg, os.path.join(tmp, leg[0]), refs,
                                   dp_bytes, state, cfg)
                legs[leg[0]] = rec
                failures += f
        del state
        torch.cuda.empty_cache()
        donation = donation_check()
        log(f"  donation: {donation}")
        if not (donation["bit_equal"] and donation["storage_kept"]):
            failures.append(f"donation: {donation}")
        peaks = donation["update_peak_bytes"]
        if peaks["chunked"] > peaks["whole"]:
            failures.append(f"the update in chunks raised its peak: {peaks}")
        trainer, f = check_trainer(argv, work, out)
        failures += f
    finally:
        shutil.rmtree(tmp)
    log("  " + card)
    if failures:
        raise AssertionError("phase 8c: " + "; ".join(failures))
    launches = {name: leg["launches"] for name, leg in legs.items()}
    return dict(legs=legs, spawns=spawns, donation=donation,
                trainer=trainer, launches=launches, card=card)


def leaf_errors(grads_k, grads_p):
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in grads_p.values())))
    errs = {}
    for k, gp in grads_p.items():
        gk = grads_k[k]
        if (gp.norm() < NEGLIGIBLE * gnorm
                and gk.norm() < NEGLIGIBLE * gnorm):
            continue
        errs[k] = float((gk.double() - gp.double()).norm()
                        / gp.double().norm().clamp(min=1e-30))
    return errs


class MixedMSDA(torch.autograd.Function):
    """MSDA whose forward and backward each come from the kernel or from
    the plain version: phase 5b's witnesses that isolate one kernel."""

    @staticmethod
    def forward(ctx, value, shapes, loc, attn, fwd_kernel, bwd_kernel):
        ctx.shapes, ctx.bwd_kernel = tuple(shapes), bwd_kernel
        ctx.save_for_backward(value, loc, attn)
        fwd = msda.ms_deform_attn_cuda if fwd_kernel else ms_deform_attn
        return fwd(value, shapes, loc, attn)

    @staticmethod
    def backward(ctx, g):
        value, loc, attn = ctx.saved_tensors
        bwd = (msda.ms_deform_attn_bwd_cuda if ctx.bwd_kernel
               else ms_deform_attn_backward_autograd)
        d_value, d_loc, d_attn = bwd(value, ctx.shapes, loc, attn,
                                     g.contiguous())
        return d_value, None, d_loc, d_attn, None, None


def model_grad_phase():
    log("== phase 5b: both kernels inside the model, float32 gradients")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pred = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=1,
                         cfg_options={"model.dtype": "float32"})
    det = refine_boxes(pred.detector, seed=2)
    img = np.random.RandomState(2).randint(0, 256, (599, 401, 3)).astype(
        np.uint8)
    images, hw, _ = pred.preprocess(img)
    params = {k: p for k, p in det.named_parameters()}
    gen = torch.Generator("cuda").manual_seed(3)
    noise_gen = torch.Generator("cuda").manual_seed(4)
    kernels = tr.ms_deform_attn_auto

    def rounded(value, shapes, loc, attn):
        """The plain version with its output moved by about one float32
        rounding (a relative 2**-24 draw, added in float32)."""
        out = ms_deform_attn(value, shapes, loc, attn)
        r = torch.rand(out.shape, device="cuda", generator=noise_gen)
        return out + out.detach() * ((2 * r - 1) * 2 ** -24)

    dispatch = {
        "kernels": kernels,
        "plain": ms_deform_attn,
        "kernel_fwd_plain_bwd": lambda v, s, lc, a: MixedMSDA.apply(
            v, s, lc, a, True, False),
        "plain_fwd_kernel_bwd": lambda v, s, lc, a: MixedMSDA.apply(
            v, s, lc, a, False, True),
        "plain_rounded": rounded,
    }

    def grads_of(loss_fn, name):
        det.zero_grad(set_to_none=True)
        tr.ms_deform_attn_auto = dispatch[name]
        try:
            loss_fn().backward()
        finally:
            tr.ms_deform_attn_auto = kernels
        return {k: p.grad.detach().clone() for k, p in params.items()
                if p.grad is not None}

    proj_mem = None

    def enc_loss():
        nonlocal proj_mem
        mem = det.encode_images(images, hw)["memory"]
        if proj_mem is None:
            proj_mem = torch.randn(mem.shape, device="cuda", generator=gen)
        return (mem.float() * proj_mem).sum()

    bwd0 = msda.ms_deform_attn_bwd_cuda.launches
    g = {"kernels": grads_of(enc_loss, "kernels")}
    if msda.ms_deform_attn_bwd_cuda.launches - bwd0 != 6:
        raise AssertionError("the encoder backward did not run the kernel")
    for name in dispatch:
        if name != "kernels":
            g[name] = grads_of(enc_loss, name)
    # the kernels against themselves: the d_value scatter's atomic order
    # is not fixed, so this is the noise floor of every comparison
    g["kernels_again"] = grads_of(enc_loss, "kernels")
    # (name, got, reference, limit): the comparison of record (both
    # kernels against both plain versions), then each kernel alone, then
    # the witnesses with no limit of their own
    comparisons = [
        ("encoder", "kernels", "plain", TOL_GRAD_LEAF),
        ("encoder_bwd_kernel_on_kernel_fwd", "kernels",
         "kernel_fwd_plain_bwd", TOL_BWD_ONLY),
        ("encoder_bwd_kernel_on_plain_fwd", "plain_fwd_kernel_bwd", "plain",
         TOL_BWD_ONLY),
        ("encoder_fwd_kernel", "kernel_fwd_plain_bwd", "plain",
         TOL_GRAD_LEAF),
        ("encoder_kernel_vs_kernel", "kernels_again", "kernels", None),
        ("encoder_plain_vs_rounded_plain", "plain_rounded", "plain", None),
    ]
    errs = {part: (leaf_errors(g[a], g[b]), tol)
            for part, a, b, tol in comparisons}
    del g
    torch.cuda.empty_cache()

    with torch.no_grad():
        enc = det.encode_images(images, hw)         # one shared selection
    proj_hs = None

    def dec_loss():
        nonlocal proj_hs
        hs = det.decode_queries(enc)["hs"]
        if proj_hs is None:
            proj_hs = torch.randn(hs.shape, device="cuda", generator=gen)
        return (hs.float() * proj_hs).sum()

    bwd0 = msda.ms_deform_attn_bwd_cuda.launches
    gk = grads_of(dec_loss, "kernels")
    if msda.ms_deform_attn_bwd_cuda.launches - bwd0 != 6:
        raise AssertionError("the decoder backward did not run the kernel")
    gd = {"kernels": gk}
    for name in dispatch:
        if name != "kernels":
            gd[name] = grads_of(dec_loss, name)
    gd["kernels_again"] = grads_of(dec_loss, "kernels")
    # the encoder's comparisons on the decoder; where the encoder's limit
    # is TOL_GRAD_LEAF, the decoder's is DECODER_WITNESS_FACTOR times its
    # sub-rounding witness in this call
    witness = leaf_errors(gd["plain_rounded"], gd["plain"])
    witness_worst = max(witness.values())
    decoder_tol = DECODER_WITNESS_FACTOR * witness_worst
    for part, a, b, tol in comparisons:
        errs["decoder" + part[len("encoder"):]] = (
            leaf_errors(gd[a], gd[b]),
            decoder_tol if tol == TOL_GRAD_LEAF else tol)
    log(f"  decoder limit {decoder_tol:.3e}: {DECODER_WITNESS_FACTOR} x the "
        f"sub-rounding witness's worst leaf {witness_worst:.3e} "
        f"({max(witness, key=witness.get)}; the plain version moved by one "
        "float32 rounding)")
    del gd
    summary, failed = {}, []
    for part, (e, tol) in errs.items():
        worst = max(e, key=e.get)
        summary[part] = dict(leaves=len(e), worst_leaf=worst,
                             worst_rel_l2=e[worst],
                             median_rel_l2=float(np.median(list(
                                 e.values()))), tol=tol)
        if part.startswith("decoder") and tol == decoder_tol:
            summary[part]["witness_worst_rel_l2"] = witness_worst
        beside = (f", the witness's {witness_worst:.3e}"
                  if "witness_worst_rel_l2" in summary[part] else "")
        log(f"  {part}: {len(e)} leaves, worst relative L2 {e[worst]:.3e} "
            f"({worst}), median {summary[part]['median_rel_l2']:.3e} "
            f"(tol {tol}{beside})")
        if len(e) < 20 or (tol is not None and e[worst] > tol):
            failed.append(part)
    if failed:
        raise AssertionError(f"gradients out of tolerance: "
                             f"{[(p, summary[p]) for p in failed]}")
    del det, pred, enc, gk
    torch.cuda.empty_cache()
    return summary


# --------------------------------------------------------------------------
# phases 9 and 9b: the served program, exported and packaged
# --------------------------------------------------------------------------


def warm_ms(fn, args, reps):
    """ms per call of fn(*a) over `reps` rounds of `args`, after one."""
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for a in args:
            fn(*a)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (reps * len(args))


def float32_matmuls(exact):
    """cuBLAS without TF32; cuDNN without it (exact) or at torch's
    default, with it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = not exact


class SelectionGiven(torch.nn.Module):
    """The served top-k program with its two-stage selection given:
    forward(images, img_hw, refpoint_unsig) -> (encoder memory, boxes,
    scores, labels), the decoder run from `refpoint_unsig` (B, nq, 4)
    instead of the encoder's own top-k proposals. With eager's selection
    it answers as eager `predict` does, so a package of it can be held to
    eager where the selection's near ties would otherwise decide."""

    def __init__(self, detector):
        super().__init__()
        self.detector = detector

    def forward(self, images, img_hw, refpoint_unsig):
        enc = self.detector.encode_images(images, img_hw)
        enc["refpoint_unsig"] = refpoint_unsig
        out = self.detector(images, img_hw, enc=enc)
        return (enc["memory"],) + tuple(decode_topk(
            out["cls"][-1], out["coord"][-1], img_hw))


def run_exported(tmp):
    """Phase 9's loading process: load each artifact of the plan
    (`plan.json`: {entry: {file, keys: the request keys of its bucket,
    given: whether it takes the request's `refpoint` too, float32,
    profile}}; a torch.export program or a package), run it on its packed
    requests with the MSDA counts set to 0 before each run and read after,
    time it, trace it where asked, and write the outputs and numbers into
    `tmp`. A float32 entry runs with TF32 off, as its eager reference
    does; the others at torch's defaults, as the runner does."""
    inputs = np.load(os.path.join(tmp, "inputs.npz"))
    with open(os.path.join(tmp, "plan.json")) as f:
        plan = json.load(f)
    outs, res = {}, {}
    for name, entry in plan.items():
        float32_matmuls(entry["float32"])
        reqs = [(k, tuple(torch.from_numpy(inputs[f"{part}_{k}"]).cuda()
                          for part in ("images", "hw") + (
                              ("refpoint",) if entry["given"] else ())))
                for k in entry["keys"]]
        t0 = time.perf_counter()
        program = export_model.load_program(os.path.join(tmp,
                                                         entry["file"]))
        load_s = time.perf_counter() - t0
        runs = []
        with torch.inference_mode():
            for k, args in reqs:
                reset_counts()
                got = program(*args)
                torch.cuda.synchronize()
                runs.append(dict(request=k,
                                 launches=msda.ms_deform_attn_cuda.launches,
                                 by_width=dict(msda.ms_deform_attn_cuda
                                               .launches_by_width),
                                 bwd=msda.ms_deform_attn_bwd_cuda.launches))
                for i, t in enumerate(got):
                    outs[f"{name}_{k}_{i}"] = t.cpu().numpy()
            calls = [args for _, args in reqs]
            res[name] = dict(load_s=load_s, runs=runs,
                             warm_ms=warm_ms(program, calls, EXPORT_REPS))
            if entry["profile"]:
                res[name]["trace"] = request_trace(program, calls,
                                                   res[name]["warm_ms"])
        del program
    np.savez(os.path.join(tmp, "outputs.npz"), **outs)
    with open(os.path.join(tmp, "loaded.json"), "w") as f:
        json.dump(res, f)


def request_trace(fn, calls, request_ms):
    """Device time of one warm pass of fn over `calls`, per request, from
    a torch.profiler trace: kernel ms, busy ms (the union of the device
    intervals), busy over the untraced `request_ms`, and the MSDA forward
    kernel's ms."""
    busy, kernels = profile_predict.device_trace(
        lambda: [fn(*a) for a in calls])
    n = len(calls)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    return dict(kernel_ms=sum(kernels.values()) / n, busy_ms=busy / n,
                busy_share=busy / n / request_ms,
                msda_ms=sum(v for k, v in kernels.items()
                            if "msda_fwd" in k) / n)


def package_child(tmp, name, float32):
    """Phase 9b's compiling process for program `name`: the
    `ExportedProgram` saved as `name.pt2` in `tmp` loaded and packaged by
    `tools.export_model.package_program` into `name.pkg.pt2` (TF32 off for
    a float32 program, as its eager reference runs); its compile s into
    `name.compile.json`."""
    float32_matmuls(float32)
    exported = torch.export.load(os.path.join(tmp, f"{name}.pt2"))
    t0 = time.perf_counter()
    export_model.package_program(exported,
                                 os.path.join(tmp, f"{name}.pkg.pt2"))
    with open(os.path.join(tmp, f"{name}.compile.json"), "w") as f:
        json.dump({"compile_s": time.perf_counter() - t0,
                   "compile_threads": torch._inductor.config.compile_threads,
                   "ended_unix": time.time()}, f)


def kept_set(boxes, scores, labels):
    return {(int(lab), tuple(b.tolist())) for b, s, lab in
            zip(boxes, scores, labels) if s > 0}


def bf16_nudge(x, step):
    """x (float32) rounded to bfloat16 and moved `step` units in its last
    place away from zero (toward it for a negative step); zeros stay."""
    xb = x.to(torch.bfloat16)
    bits = xb.view(torch.int16)
    moved = torch.where(xb != 0, bits + step, bits)
    return moved.view(torch.bfloat16).float()


def sorted_scores_distance(got, want):
    """Max abs difference of two answers' scores in descending order: one
    image's answers, robust to near ties trading places."""
    order = [np.sort(a[1].astype(np.float64))[::-1] for a in (got, want)]
    return float(np.abs(order[0] - order[1]).max())


def held_by_rank(got, want, extent, rtol, atol):
    """One image's top-k answer (boxes, scores, labels) held to another by
    rank, within rtol / atol; the boxes in units of the image's `extent`
    (h, w), as the detector predicts them. The scores in their descending
    order must be close; at each rank the detection must equal (its label
    exactly, its box within the tolerance) the other answer's at that
    rank, or at another rank whose score is within the tolerance of its
    own (a near tie that the two programs' sums order differently), each
    detection of the other answer taken once. A detection left without a
    counterpart is excused only where its score is within the tolerance
    of the other answer's last (the pair that crosses the top-k cut).
    Returns the numbers; `failed` lists the ranks that do not hold."""
    scale = np.array([extent[1], extent[0]] * 2, np.float64)
    (gb, gs, gl), (wb, ws, wl) = [
        (b.astype(np.float64) / scale, s.astype(np.float64), lab)
        for b, s, lab in (got, want)]

    def close(a, b):
        return np.abs(a - b) <= atol + rtol * np.abs(b)

    taken = np.zeros(len(ws), bool)
    same = tie = cut = 0
    failed, box_err = [], 0.0
    for i in range(len(gs)):
        cands = sorted(np.flatnonzero(close(gs[i], ws) & ~taken),
                       key=lambda j: abs(j - i))
        hit = next((j for j in cands if wl[j] == gl[i]
                    and close(gb[i], wb[j]).all()), None)
        if hit is not None:
            taken[hit] = True
            same, tie = same + int(hit == i), tie + int(hit != i)
            box_err = max(box_err, float(np.abs(gb[i] - wb[hit]).max()))
        elif close(gs[i], ws[-1]):
            cut += 1
        else:
            failed.append(i)
    if not close(gs, ws).all():
        failed.append("scores")
    return dict(score_err=float(np.abs(gs - ws).max()), box_err=box_err,
                same_rank=same, tie=tie, cut=cut, failed=failed)


def serving_phase(card):
    """Phases 9 and 9b, as a generator. Its first step (phase 9) exports
    the served programs, starts their compiles and computes the eager
    references; the caller runs other phases while they compile. Its
    second (9b) waits for the compiles, times eager, runs every artifact
    in a fresh process and in the runner, checks them and yields the
    record. Closing it early kills the compiles."""
    log(f"== phase 9: the serving program exported by tools.export_model "
        f"(torch.export, batch 1, bucket {EXPORT_BUCKET}), loaded and run "
        f"by a fresh process")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    float32_matmuls(True)          # the float32 reference; bf16 unaffected
    pred = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=0)
    det = refine_boxes(pred.detector, seed=0)
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in REQUESTS]
    packed = {str(i): (img,) + pred.preprocess(img)
              for i, img in enumerate(images)}

    def keys_of(bucket):
        return sorted(k for k, v in packed.items()
                      if tuple(v[1].shape[1:3]) == bucket)

    land = keys_of(EXPORT_BUCKET)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    procs = {}
    try:
        arrays = {f"{part}_{k}": t.cpu().numpy()
                  for k, (_, im, hw, _) in packed.items()
                  for part, t in (("images", im), ("hw", hw))}
        plan, record, eager, witness, float32 = {}, {}, {}, {}, {}
        t_compile, t_compile_unix = time.perf_counter(), time.time()
        env = dict(os.environ,
                   TORCHINDUCTOR_COMPILE_THREADS=str(PACKAGE_THREADS))

        def package(name, exported, bucket, t0, given=False):
            """The program saved, its compiling process started (this
            script with PACKAGE_FLAG), and its package put in the loading
            process's plan."""
            path = os.path.join(tmp, f"{name}.pt2")
            torch.export.save(exported, path)
            float32[name] = given
            with open(os.path.join(tmp, f"{name}.compile.log"), "w") as f:
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     PACKAGE_FLAG, tmp, name, str(int(given))], stdout=f,
                    stderr=subprocess.STDOUT, env=env,
                    preexec_fn=lambda: os.nice(PACKAGE_NICE))
            record[name] = dict(started_s=time.perf_counter() - t_compile)
            plan[f"package_{name}"] = dict(
                file=f"{name}.pkg.pt2", keys=keys_of(bucket), given=given,
                float32=given, profile=name == "topk")
            record[name].update(bucket=bucket,
                                export_s=time.perf_counter() - t0,
                                bytes=os.path.getsize(path),
                                requests=[REQUESTS[int(k)]
                                          for k in keys_of(bucket)])

        # each program exported and saved, its compile started at once; the
        # references, which are not timed, computed while they compile
        for name, use_nms, bucket in SERVED:
            t0 = time.perf_counter()
            package(name, export_model.export_program(det, 1, bucket,
                                                      use_nms), bucket, t0)
            if bucket == EXPORT_BUCKET:       # phase 9 runs the .pt2 too
                plan[f"export_{name}"] = dict(
                    file=f"{name}.pt2", keys=land, given=False,
                    float32=False, profile=False)
        # the float32 program: the same seeded weights in float32, its
        # decoder run from eager's own selection, which the package takes
        # as an input
        pred32 = init_detector(CONFIG, None, device="cuda", use_nms=False,
                               seed=0, cfg_options={"model.dtype":
                                                    "float32"})
        given = SelectionGiven(refine_boxes(pred32.detector, seed=0)).eval()
        ref_of, witness32 = {}, {}
        with torch.inference_mode():
            for k in land:
                _, im, hw, _ = packed[k]
                ref_of[k] = given.detector.encode_images(
                    im, hw)["refpoint_unsig"]
                arrays[f"refpoint_{k}"] = ref_of[k].cpu().numpy()
        t0 = time.perf_counter()
        with torch.no_grad():
            exported = torch.export.export(given, tuple(
                torch.from_numpy(arrays[f"{part}_{land[0]}"]).cuda()
                for part in ("images", "hw", "refpoint")))
        package(FLOAT32_PACKAGE, exported, EXPORT_BUCKET, t0, given=True)
        del exported
        with torch.inference_mode():
            for k in land:
                _, im, hw, _ = packed[k]
                out = given(im, hw, torch.from_numpy(
                    arrays[f"refpoint_{k}"]).cuda())
                eager[(FLOAT32_PACKAGE, k)] = [t.cpu().numpy() for t in out]
                # with its own selection it is eager top-k `predict`
                if not all(torch.equal(a, b) for a, b in zip(
                        out[1:], predict(given.detector, im, hw))):
                    raise AssertionError("SelectionGiven with eager's "
                                         "selection differs from predict")
                # why the selection is given: eager itself, on its input
                # moved by one float32 rounding, keeps its proposals or
                # not, and its answer holds by rank only where it keeps
                # them
                x = prepare_images(im, hw)
                for sign in (1.0, -1.0):
                    moved = torch.nextafter(x, torch.full_like(
                        x, sign * math.inf))
                    ref_w = given.detector.encode_images(
                        moved, hw)["refpoint_unsig"]
                    h = held_by_rank(
                        [t[0].cpu().numpy() for t in predict(
                            given.detector, moved, hw)],
                        [t[0] for t in eager[(FLOAT32_PACKAGE, k)][1:]],
                        arrays[f"hw_{k}"][0], **FLOAT32_TOL)
                    witness32[(k, sign)] = dict(
                        selection_kept=bool(torch.allclose(
                            ref_w, ref_of[k], **FLOAT32_TOL)),
                        failed=len(h["failed"]), same_rank=h["same_rank"])
        log(f"  float32 witnesses (eager top-k on the request moved by one "
            f"float32 rounding, against eager by rank within {FLOAT32_TOL}):"
            + ";".join(f" request {REQUESTS[int(k)]} {sign:+.0f}: "
                        f"proposals kept {w['selection_kept']}, "
                        f"{w['same_rank']} at the same rank, "
                        f"{w['failed']} failed"
                        for (k, sign), w in witness32.items()))
        record[FLOAT32_PACKAGE]["witness"] = list(witness32.values())
        del pred32, given
        for name, use_nms, bucket in SERVED:
            for k in keys_of(bucket):
                _, im, hw, _ = packed[k]
                eager[(name, k)] = [t.cpu().numpy() for t in predict(
                    det, im, hw, use_nms)]
                x = prepare_images(im, hw)
                witness[(name, k)] = [[t.cpu().numpy() for t in predict(
                    det, bf16_nudge(x, step), hw, use_nms)]
                    for step in WITNESS_NUDGES]
        np.savez(os.path.join(tmp, "inputs.npz"), **arrays)
        for name, rec in record.items():
            log(f"  {name}: bucket {rec['bucket']}, export "
                f"{rec['export_s']:.1f} s, {rec['bytes']:,} bytes")
        # the detector is made again from its seed for 9b's eager timing:
        # the phases in between run without it on the card
        del pred, det
        gc.collect()
        torch.cuda.empty_cache()
        references_s = time.perf_counter() - t_compile
        log(f"  the compiles go on beside the next phases (exports and "
            f"references {references_s:.1f} s)")
        yield

        log(f"== phase 9b: the serving programs packaged by AOTInductor "
            f"(tools.export_model.package_program, {len(procs)} compiling "
            f"processes, each started once phase 9 saved its program, "
            f"{PACKAGE_THREADS} compile threads each), run by a fresh Python"
            f" process and by the C++ runner")
        pred = init_detector(CONFIG, None, device="cuda", use_nms=False,
                             seed=0)
        det = refine_boxes(pred.detector, seed=0)
        failed = {}
        for name, proc in procs.items():
            try:
                proc.wait(timeout=max(1.0, PACKAGE_TIMEOUT - (
                    time.perf_counter() - t_compile)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"packaging {name}: killed after "
                                     f"{PACKAGE_TIMEOUT} s")
            if proc.returncode != 0:
                with open(os.path.join(tmp, f"{name}.compile.log")) as f:
                    failed[name] = (f"exited {proc.returncode}:\n"
                                    f"{f.read()[-3000:]}")
        compile_wall_s = time.perf_counter() - t_compile
        if failed:
            raise AssertionError(f"packaging failed: {failed}")
        for name in procs:
            with open(os.path.join(tmp, f"{name}.compile.json")) as f:
                record[name].update(json.load(f))
            record[name]["ended_s"] = record[name].pop("ended_unix") \
                - t_compile_unix
            record[name]["package_bytes"] = os.path.getsize(
                os.path.join(tmp, f"{name}.pkg.pt2"))
            log(f"  {name}: package compile {record[name]['compile_s']:.1f}"
                f" s ({record[name]['compile_threads']} compile threads), "
                f"started {record[name]['started_s']:.1f} s after the first "
                f"export, ended {record[name]['ended_s']:.1f} s after it, "
                f"{record[name]['package_bytes']:,} bytes")
        log(f"  from the first export to the end of 9b's wait "
            f"{compile_wall_s:.1f} s of wall time, phase 9's exports and "
            f"references and the phases after it beside the compiles")
        # timed after the compiles, with the card and the host to itself
        for name, use_nms, bucket in SERVED:
            calls = [packed[k][1:3] for k in keys_of(bucket)]
            record[name]["eager_ms"] = warm_ms(
                lambda im, hw: predict(det, im, hw, use_nms), calls,
                EXPORT_REPS)
            if name == "topk":
                record[name]["eager_trace"] = request_trace(
                    lambda im, hw: predict(det, im, hw, use_nms), calls,
                    record[name]["eager_ms"])
        del pred, det
        gc.collect()
        torch.cuda.empty_cache()
        with open(os.path.join(tmp, "plan.json"), "w") as f:
            json.dump(plan, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               EXPORT_FLAG, tmp], capture_output=True,
                              text=True, timeout=PACKAGE_TIMEOUT)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"loading process exited {proc.returncode}:"
                                 f"\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        with open(os.path.join(tmp, "loaded.json")) as f:
            loaded = json.load(f)
        outs = np.load(os.path.join(tmp, "outputs.npz"))
        runner_bin = serve_runner.build()[0]
        libpython_free, ldd = serve_runner.python_free(runner_bin)
        if not libpython_free:
            raise AssertionError(f"the runner links libpython:\n{ldd}")

        failures = []
        launches = {"export": 0, "package": 0, "runner": 0}

        def check_launches(runs, path, what, width=MAIN_WIDTH):
            for run in runs:
                if (run["launches"] != 12 or run["bwd"] != 0
                        or run["by_width"] != {str(width): 12}):
                    failures.append(f"{what} request {run['request']}: "
                                    f"MSDA launches {run}, not 12 through "
                                    f"width {width}")
                launches[path] += run["launches"]

        def answer(entry, k, n=3):
            return [outs[f"{entry}_{k}_{i}"] for i in range(n)]

        # phase 9: the torch.export programs, bit-equal to eager predict
        for name, use_nms, bucket in SERVED:
            if f"export_{name}" not in plan:
                continue
            rec = record[name]
            rec["export"] = loaded[f"export_{name}"]
            check_launches(rec["export"]["runs"], "export",
                           f"{name} torch.export program")
            for k in land:
                got, want = answer(f"export_{name}", k), eager[(name, k)]
                if not use_nms:
                    bad = [part for part, g, w in zip(
                        ("boxes", "scores", "labels"), got, want)
                        if not np.array_equal(g, w)]
                    if bad:
                        failures.append(
                            f"{name} torch.export program, request {k}: "
                            f"{bad} differ from eager predict")
                elif kept_set(*(a[0] for a in got)) != kept_set(
                        *(a[0] for a in want)):
                    failures.append(f"{name} torch.export program, request"
                                    f" {k}: kept sets differ from eager")
                img, _, _, sf = packed[k]
                check_answer(img, Predictor.postprocess(
                    [torch.from_numpy(a) for a in got], sf, -1.0))
            log(f"  {name} torch.export program: load "
                f"{rec['export']['load_s']:.1f} s; warm ms per request "
                f"{rec['export']['warm_ms']:.2f} against eager predict "
                f"{rec['eager_ms']:.2f}; MSDA launches per run "
                f"{[r['launches'] for r in rec['export']['runs']]}; "
                + ("boxes, scores, labels equal eager's to the bit"
                   if not use_nms else "kept sets equal eager's"))

        # phase 9b: the packages
        inputs = np.load(os.path.join(tmp, "inputs.npz"))
        for name in procs:
            rec, entry = record[name], plan[f"package_{name}"]
            keys = entry["keys"]
            rec["package"] = loaded[f"package_{name}"]
            # the vector instance of the program's dtype (bfloat16: 8
            # channels per lane, float32: 4)
            check_launches(rec["package"]["runs"], "package",
                           f"{name} package in Python", msda.kernel_width(
                               D, torch.float32 if float32[name]
                               else torch.bfloat16))
            if entry["given"]:
                # held to float32 eager by position (the encoder memory)
                # and by rank (the answer from the same selection): a
                # fault in the backbone, the encoder, the decoder, the
                # box head, the decode or the score-to-box pairing shows
                held = []
                for k in keys:
                    got = answer(f"package_{name}", k, 4)
                    want = eager[(name, k)]
                    img, _, _, sf = packed[k]
                    check_answer(img, Predictor.postprocess(
                        [torch.from_numpy(a) for a in got[1:]], sf, -1.0))
                    h = held_by_rank([a[0] for a in got[1:]],
                                     [a[0] for a in want[1:]],
                                     inputs[f"hw_{k}"][0], **FLOAT32_TOL)
                    h["memory_err"] = float(np.abs(
                        got[0].astype(np.float64) - want[0]).max())
                    if not np.allclose(got[0], want[0], **FLOAT32_TOL):
                        h["failed"].append("memory")
                    if h["failed"]:
                        failures.append(f"{name} request {k}: "
                                        f"{h['failed'][:10]} differ from "
                                        f"float32 eager beyond "
                                        f"{FLOAT32_TOL}")
                    held.append(h)
                rec["against_eager"] = held
                log(f"  {name} against float32 eager (TF32 off; "
                    f"{FLOAT32_TOL}; boxes in units of the image): "
                    + "; ".join(f"request {REQUESTS[int(k)]}: memory err "
                                f"{h['memory_err']:.3e}, score err "
                                f"{h['score_err']:.3e}, box err "
                                f"{h['box_err']:.3e}, "
                                f"{h['same_rank']} at the same rank, "
                                f"{h['tie']} in a near tie, {h['cut']} at "
                                f"the cut, failed {h['failed'][:10]}"
                                for k, h in zip(keys, held)))
                log(f"  {name}: load {rec['package']['load_s']:.2f} s; "
                    f"MSDA launches per run "
                    f"{[r['launches'] for r in rec['package']['runs']]}")
                continue
            runner = serve_runner.run(
                os.path.join(tmp, f"{name}.pkg.pt2"),
                [(inputs[f"images_{k}"], inputs[f"hw_{k}"]) for k in keys],
                "cuda", EXPORT_REPS, timeout=PACKAGE_TIMEOUT)
            rec["runner"] = {k: v for k, v in runner.items()
                             if k != "outputs"}
            check_launches([dict(request=k, launches=sum(
                run["launches"].values()), bwd=0, by_width={
                    w: c for w, c in run["launches"].items() if c})
                for k, run in zip(keys, runner["runs"])], "runner",
                f"{name} runner")
            dist_pkg, dist_wit = [], []
            for k, got_r in zip(keys, runner["outputs"]):
                got = answer(f"package_{name}", k)
                if not all(np.array_equal(a, b) and a.dtype == b.dtype
                           for a, b in zip(got, got_r)):
                    failures.append(f"{name} request {k}: the runner's "
                                    "outputs differ from the Python-loaded "
                                    "package's")
                img, _, _, sf = packed[k]
                for a in (got, got_r):
                    check_answer(img, Predictor.postprocess(
                        [torch.from_numpy(t) for t in a], sf, -1.0))
                want = [a[0] for a in eager[(name, k)]]
                dist_pkg.append(sorted_scores_distance(
                    [a[0] for a in got], want))
                dist_wit += [sorted_scores_distance([a[0] for a in w], want)
                             for w in witness[(name, k)]]
            limit = PACKAGE_WITNESS_FACTOR * max(dist_wit)
            rec["against_eager"] = dict(package=dist_pkg, witness=dist_wit,
                                        limit=limit)
            log(f"  {name} against eager predict (scores in descending "
                f"order, max abs): package {dist_pkg}, one-bf16-rounding "
                f"witnesses {dist_wit}; limit {limit}")
            if max(dist_pkg) > limit:
                failures.append(f"{name}: scores {dist_pkg} against eager "
                                f"beyond the witnesses' limit {limit}")
            log(f"  {name}: load s, package in Python "
                f"{rec['package']['load_s']:.2f}, runner "
                f"{runner['load_s']:.2f}; warm ms per request, package in "
                f"Python {rec['package']['warm_ms']:.2f}, runner "
                f"{runner['warm_ms']:.2f}, eager predict "
                f"{rec['eager_ms']:.2f}"
                + (f", torch.export program {rec['export']['warm_ms']:.2f}"
                   if "export" in rec else "")
                + f"; MSDA launches per run, package "
                f"{[r['launches'] for r in rec['package']['runs']]}, runner "
                f"{[r['launches'] for r in runner['runs']]}; the runner's "
                f"outputs equal the package's in Python")
        for what, t in (("eager predict", record["topk"]["eager_trace"]),
                        ("package in Python",
                         record["topk"]["package"]["trace"])):
            log(f"  topk {what}, one traced pass: device kernels "
                f"{t['kernel_ms']:.2f} ms, busy {t['busy_ms']:.2f} ms per "
                f"request, {100 * t['busy_share']:.1f} % of the untraced "
                f"request; MSDA forward {t['msda_ms']:.3f} ms")
        log(f"  the runner {runner_bin}: no libpython in ldd, an emptied "
            f"environment ({sorted(serve_runner.runner_env())}); loading "
            f"process {child_s:.1f} s")
        log("  " + card)
        if failures:
            raise AssertionError("phases 9 / 9b: " + "; ".join(failures))
        yield dict(record, launches=launches, child_s=child_s,
                   compile_wall_s=compile_wall_s, references_s=references_s,
                   package_threads=PACKAGE_THREADS, torch=torch.__version__,
                   cuda=torch.version.cuda, card=card)
    finally:
        for proc in procs.values():          # none outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp)


# --------------------------------------------------------------------------
# phase 10: remat
# --------------------------------------------------------------------------


def snapshot(state):
    def copy_of(m):
        return None if m is None else {
            k: v.detach().clone() for k, v in m.state_dict().items()}
    return dict(model=copy_of(state.model), teacher=copy_of(state.teacher),
                projector=copy_of(state.projector), step=state.step,
                opt=copy.deepcopy(state.optimizer.adamw.state_dict()))


def restore(state, snap):
    for key in ("model", "teacher", "projector"):
        if snap[key] is not None:
            getattr(state, key).load_state_dict(snap[key])
    state.optimizer.adamw.load_state_dict(copy.deepcopy(snap["opt"]))
    state.step = snap["step"]


def remat_runs(state, step_fn, batch, want_launches, what):
    """One step from one state REMAT_ROUNDS times in turns: no remat, remat,
    no remat, remat, ... Returns the runs (losses, launches, ms, the step's
    own peak memory, trainable parameter updates and gradients) and the
    state after the first."""
    start = snapshot(state)
    params = {k: p for k, p in state.model.named_parameters()
              if p.requires_grad}
    if state.projector is not None:
        params.update({"projector." + k: p for k, p in
                       state.projector.named_parameters()})
    before = {k: p.detach().clone() for k, p in params.items()}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()      # state, snapshot, batch
    runs, after_first = [], None
    for remat in (False, True) * REMAT_ROUNDS:
        restore(state, start)
        state.model.bbox_head.transformer.remat = remat
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fwd = msda.ms_deform_attn_cuda.launches
        bwd = msda.ms_deform_attn_bwd_cuda.launches
        if (fwd, bwd) != want_launches:
            raise AssertionError(f"{what} remat={remat}: {fwd} forward and "
                                 f"{bwd} backward MSDA launches, not "
                                 f"{want_launches}")
        assert_vector(msda.ms_deform_attn_cuda, f"{what} forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda, f"{what} backward")
        runs.append(dict(
            remat=remat, ms=ms, launches=(fwd, bwd),
            peak=held + torch.cuda.max_memory_allocated() - base,
            losses={k: float(v) for k, v in metrics.items()
                    if "loss" in k and isinstance(v, torch.Tensor)
                    and v.dim() == 0},
            update={k: p.detach() - before[k] for k, p in params.items()},
            grad={k: p.grad.detach().clone() for k, p in params.items()
                  if p.grad is not None}))
        if after_first is None:
            after_first = snapshot(state)
    state.model.bbox_head.transformer.remat = False
    return runs, after_first


def remat_case(state, step_fn, batch, want_launches, what, out, launches):
    """Phase 10 for one step: the runs in turns, their check into
    out[what], the remat runs' launches added up; the state left as the
    first no-remat run left it (the next step's start)."""
    runs, after = remat_runs(state, step_fn, batch, want_launches, what)
    out[what] = check_remat(runs, what)
    for r in runs:
        if r["remat"]:
            launches["fwd"] += r["launches"][0]
            launches["bwd"] += r["launches"][1]
    del runs
    restore(state, after)


def noise_line(n):
    """Phase 10's noise-leaf hold beside its witness, as printed."""
    if n is None:
        return "none"
    return (f"error / floor at the {n['quantile']} quantile "
            f"{n['ratio_quantile']:.2f}, the one-mode witness's "
            f"{n['witness_quantile']:.2f}, limit {n['limit']:.2f}; median "
            f"{n['ratio_median']:.2f}; max {n['ratio_max']:.2f} "
            f"({n['worst_leaf']}) beside the witness's max "
            f"{n['witness_max']:.2f}")


def remat_phase(card):
    log("== phase 10: remat (selective activation checkpointing, the MSDA "
        "output saved) against no remat, from one state")
    out, launches = {}, {"fwd": 0, "bwd": 0}
    state, cfg = init_ssod_state(SSOD_CONFIG, device="cuda", seed=0)
    refine_boxes(state.model, seed=3)
    batch = to_device(synthetic_ssod_batch(
        SSOD_SUP, SSOD_UNSUP, *SSOD_BUCKET, state.model.cfg.max_gt,
        gt_per_image=12, seed=0, student_flip=True), "cuda")
    # the warm-up step at phase 6's lowered score_thr (a supervision set),
    # then a Hungarian step from the state the first no-remat run left
    for warm_up, step_cfg in ((True, dataclasses.replace(cfg, score_thr=0.0)),
                              (False, cfg)):
        remat_case(state, make_ssod_train_step(step_cfg, warm_up), batch,
                   SSOD_LAUNCHES[warm_up],
                   f"ssod_{'warm_up' if warm_up else 'hungarian'}", out,
                   launches)
    del state, batch
    torch.cuda.empty_cache()

    state = init_train_state(CONFIG, device="cuda", seed=0)
    rng = np.random.RandomState(5)
    batches = [to_device(synthetic_batch(rng, bucket, counts,
                                         state.model.cfg.max_gt), "cuda")
               for _, bucket, counts in TRAIN_STEPS]
    for warm_up, i in ((True, 0), (False, 2)):
        remat_case(state, make_supervised_train_step(warm_up=warm_up, seed=0),
                   batches[i], (12, 12),
                   f"supervised_{'warm_up' if warm_up else 'hungarian'}",
                   out, launches)
    del state, batches
    torch.cuda.empty_cache()
    for name, r in out.items():
        g, u = r["grad"], r["update"]
        log(f"  {name}: loss terms bit-equal ({len(r['losses'])}) over "
            f"{r['runs']} runs; MSDA launches {r['launches']} with and "
            f"without remat; gradient error over {g['leaves']} leaves: worst "
            f"{g['worst']:.3e} ({g['worst_leaf']}, its floor "
            f"{g['floor_of_worst']:.3e}), median {g['median']:.3e} against "
            f"the floor's {g['floor_median']:.3e}; update error over "
            f"{u['leaves']} leaves: worst {u['worst']:.3e} ({u['worst_leaf']}"
            f", its floor {u['floor_of_worst']:.3e}), median "
            f"{u['median']:.3e} against the floor's {u['floor_median']:.3e}"
            f"; {u['noise_leaves']} noise leaves: {noise_line(u['noise'])}"
            f"; warm step "
            f"(median of {REMAT_ROUNDS - 1} in turns) "
            f"{r['ms']['no_remat']:.1f} ms without, "
            f"{r['ms']['remat']:.1f} ms with remat (runs "
            f"{[round(x, 1) for x in r['ms_runs']['no_remat']]} / "
            f"{[round(x, 1) for x in r['ms_runs']['remat']]}); peak memory "
            f"{r['peak_memory_bytes']['no_remat'] / 2 ** 30:.2f} GiB without,"
            f" {r['peak_memory_bytes']['remat'] / 2 ** 30:.2f} GiB with")
    log("  " + card)
    return dict(out, launches=launches, card=card)


# --------------------------------------------------------------------------
# phase 11: the recipe rehearsal, short
# --------------------------------------------------------------------------


def rehearsal_launches(steps, boundary, evals, n_val):
    """The MSDA launches a CLI run of `steps` step indices must make: 48
    (warm-up) or 42 forward and 24 backward per step, 12 forward per eval
    batch per model (teacher and student)."""
    fwd = sum(SSOD_LAUNCHES[s < boundary][0] for s in steps)
    fwd += evals * 2 * 12 * -(-n_val // EVAL_BATCH)
    return fwd, 24 * len(steps)


def rehearsal_phase(card):
    n, boundary = REHEARSAL_STEPS, REHEARSAL_STEPS // 2
    kill = REHEARSAL_STEPS // 2 + REHEARSAL_STEPS // 8
    log(f"== phase 11: tools.recipe_rehearsal at full width: {n} steps, "
        f"warm-up boundary {boundary}, leg 1 to {kill}, then resumed, eval "
        f"every {REHEARSAL_EVAL}, {REHEARSAL_IMGS} synthetic images")
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rehearsal_")
    try:
        t0 = time.perf_counter()
        res = recipe_rehearsal.main([
            "--steps", str(n), "--imgs", str(REHEARSAL_IMGS), "--workdir",
            tmp, "--eval-interval", str(REHEARSAL_EVAL), "--cfg-options",
            "log_interval=1"])
        wall = time.perf_counter() - t0
        if res["leg1_last_checkpoint"] != kill or res["resumed_from"] != [
                kill]:
            raise AssertionError(f"leg 1 saved {res['leg1_last_checkpoint']}"
                                 f", leg 2 resumed from "
                                 f"{res['resumed_from']}, not {kill}")
        if res["steps_logged"] != list(range(n)) or not all(
                v is not None and math.isfinite(v)
                for v in res["losses_logged"]):
            raise AssertionError(f"logged steps {res['steps_logged']}, "
                                 f"losses {res['losses_logged']}")
        want_evals = list(range(REHEARSAL_EVAL, n, REHEARSAL_EVAL))
        if sorted(res["evals"]) != want_evals:
            raise AssertionError(f"evals at {sorted(res['evals'])}, not "
                                 f"{want_evals}")
        for step, tags in res["evals"].items():
            for tag in ("teacher", "student"):
                if tag not in tags:
                    raise AssertionError(f"no Eval[{tag}] at step {step}")
                check_aps(tags[tag], f"Eval[{tag}] iter {step}")
        if not os.path.isfile(os.path.join(tmp, "REHEARSAL.md")):
            raise AssertionError("no report under the work dir")
        n_val = len(recipe_rehearsal.rehearsal_splits(REHEARSAL_IMGS)["val"])
        legs = (range(0, kill), range(kill, n))
        if len(res["msda_launches"]) != 2:
            raise AssertionError(f"launch lines {res['msda_launches']}")
        launches = {"fwd": 0, "bwd": 0}
        for leg, got in zip(legs, res["msda_launches"]):
            n_ev = sum(1 for s in want_evals if s in leg)
            want = rehearsal_launches(leg, boundary, n_ev, n_val)
            width = {str(MAIN_WIDTH): want[0]}, {str(MAIN_WIDTH): want[1]}
            if ((got["fwd"], got["bwd"]) != want
                    or (got["fwd_by_width"], got["bwd_by_width"]) != width):
                raise AssertionError(f"leg {leg}: MSDA launches {got}, not "
                                     f"{want} through width {MAIN_WIDTH}")
            launches["fwd"] += got["fwd"]
            launches["bwd"] += got["bwd"]
        log(f"  both legs exit 0 ({res['wall_leg1_s']:.1f} s, "
            f"{res['wall_leg2_s']:.1f} s); leg 2 resumed from {kill}; "
            f"median logged step {res['median_step_s'] * 1e3:.1f} ms, "
            f"{res['images_per_s']:.3f} images/s; peak memory "
            f"{res['peak_memory']}; MSDA launches per leg "
            f"{[(g['fwd'], g['bwd']) for g in res['msda_launches']]}")
        for step, tags in sorted(res["evals"].items()):
            log(f"  eval at {step}: teacher mAP "
                f"{tags['teacher']['mAP']:.4f}, student mAP "
                f"{tags['student']['mAP']:.4f}")
        log("  " + card)
        return dict(res, launches=launches, wall_s=wall, card=card)
    finally:
        shutil.rmtree(tmp)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == EXPORT_FLAG:
        run_exported(sys.argv[2])
        return
    if len(sys.argv) > 1 and sys.argv[1] == PACKAGE_FLAG:
        package_child(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
        return
    if len(sys.argv) > 1 and sys.argv[1] == TORCHRUN_FLAG:
        torchrun_cli_rank(sys.argv[2], sys.argv[3:])
        return
    t_script = time.perf_counter()
    log("== phase 1: device")
    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)

    log("== phase 2: build")

    def timed_build(build):
        t0 = time.perf_counter()
        out = build()
        return out, time.perf_counter() - t0

    # nvcc (one process per kernel source) and g++ (the host library, the
    # serving runner, and the MSDA operator library once the forward
    # kernel's library it links is there), all started together
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        host = pool.submit(timed_build, native.build)
        runner = pool.submit(timed_build, serve_runner.build)
        (paths, build_log), build_s = timed_build(msda.build)
        (op_path, _), op_build_s = timed_build(msda_cpp.build)
        (host_path, _), host_build_s = host.result()
        (runner_path, _), runner_build_s = runner.result()
    log(f"  built {', '.join(paths)} in {build_s:.1f} s; {host_path} in "
        f"{host_build_s:.1f} s; the MSDA operator library {op_path} in "
        f"{op_build_s:.1f} s after them; the serving runner {runner_path} "
        f"in {runner_build_s:.1f} s")
    for line in ptxas_summary(build_log):
        log("  ptxas: " + line)
    builds = dict(kernels_s=build_s, host_s=host_build_s,
                  op_library_s=op_build_s, runner_s=runner_build_s)

    phase_s = {"2": build_s}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[phase] = time.perf_counter() - t0
        log(f"  phase {phase}: {phase_s[phase]:.1f} s")
        return out

    rows = timed("3", kernel_phase)
    bwd_rows = timed("3b", backward_kernel_phase)
    launches, latency = timed("4", main_path_phase)
    if msda.ms_deform_attn_bwd_cuda.launches != 0:
        raise AssertionError("the serving path launched the backward kernel")
    errs = timed("4b", float32_phase)
    train = timed("5", train_phase, card)
    grad_check = timed("5b", model_grad_phase)
    ssod = timed("6", ssod_phase, card)
    host_lib = timed("7a", host_library_phase, host_build_s)
    trainer, trainer_dir = timed("7", trainer_phase, card,
                                 ssod["warm_step_ms"])
    try:
        render = timed("7r", render_phase, card, trainer_dir)
    finally:
        shutil.rmtree(trainer_dir)
    # phase 9 starts the serving programs' compiles, which run beside
    # phases 8a-11; phase 9b collects them
    serving = serving_phase(card)
    atexit.register(serving.close)       # no compile outlives a failure
    timed("9", next, serving)
    ddp, ddp_refs, legs_dir = timed("8a", ddp_phase, card,
                                    ssod["warm_step_ms"])
    atexit.register(shutil.rmtree, legs_dir, True)   # 8c removes it
    torchrun = timed("8b", torchrun_phase, card, trainer["launches_per_step"])
    layouts = timed("8c", layout_phase, card, ddp_refs, ddp, legs_dir)
    del ddp_refs
    remat = timed("10", remat_phase, card)
    rehearsal = timed("11", rehearsal_phase, card)
    served = timed("9b", next, serving)
    serving.close()

    phase_s["total"] = time.perf_counter() - t_script
    log("== time: " + ", ".join(f"phase {k} {v:.1f} s" for k, v in
                                phase_s.items() if k != "total")
        + f"; the script {phase_s['total']:.1f} s ({card})")

    main_rows = [r for r in rows if r["dtype"] == "bfloat16"
                 and r["case"] in ("encoder", "decoder")]
    bwd_main = [r for r in bwd_rows if r["dtype"] == "bfloat16"
                and r["case"] in ("encoder", "decoder")]

    def per_call_sums(rs):
        """6 encoder + 6 decoder calls."""
        return {k: sum(6 * r[k] for r in rs)
                for k in ("ms", "plain_ms", "bound_ms")}

    per_image, per_step = per_call_sums(main_rows), per_call_sums(bwd_main)
    record = {"kernels": [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "semi_detr_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "semi_detr_tpu/ops/ms_deform_attn_pallas.py:277",
        # the training path's run (phase 5); the serving path's in
        # launches_by_path
        "launches": train["launches_fwd"],
        "launches_by_path": {"serve": launches,
                             "train": train["launches_fwd"],
                             "ssod": ssod["launches_fwd"],
                             "trainer": trainer["launches_fwd"],
                             # the image demo of phase 7r
                             "demo": render["demo"]["launches_fwd"],
                             # per rank, phase 8a's two runs
                             "ddp": ddp["launches"]["fwd"],
                             # per rank, each phase 8c leg's two runs
                             **{name: launches["fwd"] for name, launches
                                in layouts["launches"].items()},
                             # the loaded programs' runs (phase 9)
                             "export": served["launches"]["export"],
                             # the packages' runs in a Python process
                             # (the Python operator) and in the C++
                             # runner (the C++ operator), phase 9b
                             "package": served["launches"]["package"],
                             "runner": served["launches"]["runner"],
                             # the remat runs of phase 10
                             "remat": remat["launches"]["fwd"],
                             # both CLI legs of phase 11
                             "rehearsal": rehearsal["launches"]["fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        # per image on the serving path (bfloat16, N=1): 6 encoder + 6
        # decoder calls
        "ms": per_image["ms"],
        "plain_ms": per_image["plain_ms"],
        "bound_ms": per_image["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in main_rows) else "operations",
        "library_ms": None,
        "cases": rows,
    }, {
        "name": "ms_deform_attn_bwd",
        "route": "cuda",
        "source": "semi_detr_tpu_torch/csrc/ms_deform_attn_bwd.cu",
        "replaces": "semi_detr_tpu/ops/ms_deform_attn_pallas.py:521",
        "launches": train["launches_bwd"],
        "launches_by_path": {"serve": 0, "train": train["launches_bwd"],
                             "ssod": ssod["launches_bwd"],
                             "trainer": trainer["launches_bwd"],
                             "demo": 0,
                             "ddp": ddp["launches"]["bwd"],
                             **{name: launches["bwd"] for name, launches
                                in layouts["launches"].items()},
                             "export": 0, "package": 0, "runner": 0,
                             "remat": remat["launches"]["bwd"],
                             "rehearsal": rehearsal["launches"]["bwd"]},
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in bwd_main),
        # per training step (batch 2, bfloat16): 6 encoder + 6 decoder calls
        "ms": per_step["ms"],
        "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in bwd_main) else "operations",
        "library_ms": None,
        "cases": bwd_rows,
    }], "card": card, "build_s": build_s, "builds": builds,
        "phase_s": phase_s,
        "request_ms": {k: v * 1e3 for k, v in latency.items()},
        "float32_request_err": errs, "train": train,
        "float32_grad_check": grad_check, "ssod": ssod,
        "host_library": host_lib, "trainer": trainer, "render": render,
        "ddp": ddp,
        "torchrun": torchrun, "layouts": layouts, "serving": served,
        "remat": remat, "rehearsal": rehearsal}
    print(json.dumps(json_safe(record), allow_nan=False), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
