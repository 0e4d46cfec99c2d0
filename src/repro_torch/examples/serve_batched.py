"""Batched serving example: prefill a prompt batch, decode greedily with a
position-tagged KV cache (rolling window for SWA archs).

  python -m repro_torch.examples.serve_batched --arch zamba2_2_7b \
      [--device cpu]

(uses the reduced smoke config of the chosen architecture, any of the
ten; a VLM's prompts come with image embeddings, an enc-dec's with
frame embeddings)
"""

import argparse

from repro_torch.launch.serve import serve


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    result = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, smoke=True, device=args.device)
    print(f"[serve] prefill {result['prefill_s']*1e3:.0f}ms, "
          f"{result['decode_s_per_token']*1e3:.1f}ms/token")
    print("[serve] generated token ids:")
    print(result["tokens"])


if __name__ == "__main__":
    main()
