"""Source separation of dataset folders, the 2021 recipe's preprocessing
(counterpart of desed_task_tpu/tools/separation.py).

Two backends with one interface (`separate`, `separate_folder`):

  * `TorchSeparationModel`: the trainable TDCN++ (models/tdcn.py) on the
    card, its weights from `training/separation_pretrain.py`'s checkpoint
    (or random from a seed, for smoke runs);
  * `SeparationModel`: Google's MixIT TDCN++ TensorFlow-v1 metagraph, run on
    the host (reference recipes/dcase2021_task4_baseline/local/
    apply_separation_model.py:28-104). It needs the downloaded checkpoint
    and raises FileNotFoundError without it; tensorflow is imported only
    when the files are there.

`separate_folder` writes `<stem>_src{i}.wav` for every wav of a folder.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _separate_folder(model, in_folder, out_folder, fs: int = 16000) -> int:
    from ..data.audio_io import read_wav, to_mono, write_wav

    in_folder, out_folder = Path(in_folder), Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    wavs = sorted(in_folder.glob("*.wav"))
    for wav in wavs:
        audio, _fs = read_wav(wav)
        for i, src in enumerate(model.separate(to_mono(audio))):
            write_wav(out_folder / f"{wav.stem}_src{i}.wav", src, fs)
    return len(wavs)


class SeparationModel:
    def __init__(self, checkpoint_path: str, metagraph_path: str):
        if not Path(metagraph_path).exists():
            raise FileNotFoundError(
                f"separation metagraph not found at {metagraph_path}; download "
                "the MixIT TDCN++ checkpoint (see the DCASE 2021 baseline "
                "instructions) before running separation"
            )
        import tensorflow.compat.v1 as tf

        tf.disable_v2_behavior()
        self.graph = tf.Graph()
        with self.graph.as_default():
            self.sess = tf.Session()
            new_saver = tf.train.import_meta_graph(metagraph_path)
            new_saver.restore(self.sess, checkpoint_path)
        self.input_placeholder = self.graph.get_tensor_by_name("input_audio/receiver_audio:0")
        self.output_tensor = self.graph.get_tensor_by_name("denoised_waveforms:0")

    def separate(self, mixture: np.ndarray) -> np.ndarray:
        """[N] mono waveform -> [n_src, N] separated sources."""
        mixture = np.asarray(mixture, np.float32)[None, None, :]
        sources = self.sess.run(self.output_tensor,
                                feed_dict={self.input_placeholder: mixture})
        return sources[0]

    separate_folder = _separate_folder


class TorchSeparationModel:
    """The TDCN++ separator on `device` (default "cuda").

    checkpoint_path: a `pretrain_separator` checkpoint (its model
    configuration and weights); without one, a TDCNPP(n_src=n_src,
    **model_kwargs) with weights drawn from seed 0 (smoke runs).
    """

    def __init__(self, checkpoint_path: str | None = None, n_src: int = 4,
                 device: str | torch.device | None = None, **model_kwargs):
        from ..device import resolve_device
        from ..models.tdcn import TDCNPP, init_tdcn

        self.device = resolve_device(device)
        if checkpoint_path:
            payload = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
            self.model = TDCNPP(**payload["config"])
            self.model.load_state_dict(payload["state_dict"])
        else:
            self.model = init_tdcn(TDCNPP(n_src=n_src, **model_kwargs),
                                   torch.Generator().manual_seed(0))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def separate(self, mixture: np.ndarray) -> np.ndarray:
        """[N] mono waveform -> [n_src, N] separated sources.

        The clip is zero-padded to max(16000, the next power of two) samples
        and the sources cut back to N, as the JAX model does (it pads to
        bound its compiles): the encoder's frames and the mixture-consistency
        residual depend on the padded length."""
        n = int(np.asarray(mixture).shape[-1])
        bucket = max(16000, 1 << (n - 1).bit_length())
        padded = np.zeros(bucket, np.float32)
        padded[:n] = mixture
        out = self.model(torch.as_tensor(padded, device=self.device)[None])
        return out[0, :, :n].cpu().numpy()

    separate_folder = _separate_folder
