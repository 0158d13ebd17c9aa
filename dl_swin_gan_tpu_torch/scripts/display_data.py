"""Save a reconstruction's magnitude or phase frames as a PNG grid and,
with `--gif`, as an animated GIF.

Counterpart of the root `scripts/display_data.py` (the reference's
`display_data.py`), with its arguments. It needs matplotlib (pillow for the
GIF).

    python -m dl_swin_gan_tpu_torch.scripts.display_data \\
        runs/x/recon/synthetic_000_12accel.im --gif cine.gif
"""

import argparse

import numpy as np

from dl_swin_gan_tpu_torch.scripts.eval import load_images


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("file", help="CFL basename (no extension)")
    parser.add_argument("--slice", type=int, default=0)
    parser.add_argument("--emap", type=int, default=0)
    parser.add_argument("--phase", action="store_true", help="show phase")
    parser.add_argument("--gif", default=None, help="write animated GIF here")
    parser.add_argument("--out", default=None, help="write PNG frame grid here")
    args = parser.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    im = load_images(args.file)[args.slice, args.emap]      # [ph, y, x]
    frames = np.angle(im) if args.phase else np.abs(im)

    if args.gif:
        from matplotlib import animation

        fig, ax = plt.subplots()
        ax.axis("off")
        art = ax.imshow(frames[0], cmap="gray")

        def update(i):
            art.set_data(frames[i])
            return [art]
        ani = animation.FuncAnimation(fig, update, frames=len(frames),
                                      interval=80, blit=True)
        ani.save(args.gif, writer="pillow")
        plt.close(fig)
        print(args.gif)
        if not args.out:
            return args.gif

    out = args.out or (args.file + ("_phase.png" if args.phase else "_mag.png"))
    n = len(frames)
    cols = min(n, 8)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        ax.axis("off")
        if i < n:
            ax.imshow(frames[i], cmap="gray")
            ax.set_title(f"ph {i}", fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(out)
    return out


if __name__ == "__main__":
    main()
